"""GNN models on the port's ops: SAGE, SAGEFused, GCN, GIN and GNNRes.

Same semantics as the JAX package's flax models, written as
``nn.Module``s:

- SAGE: lin_in -> per layer [MaxK (or ReLU) -> mean-neighbour
  aggregation; h = fc_self(x) + fc_neigh(x_agg); dropout; LayerNorm?]
  -> lin_out. SAGEFused feeds fc_self the pre-MaxK x.
- GCN: relu(lin_in) -> per layer [lin_i -> MaxK/ReLU -> dropout ->
  sym-normalised aggregation + gconv_bias_i -> LayerNorm?] -> lin_out.
- GIN: GCN's shell with (1 + gin_eps_i) x + sum-aggregation.
- GNNRes: relu(lin_in) -> per layer [x_res = res_i(x); sym aggregation
  + gconv_bias_i -> BatchNorm? -> lin1_i -> ReLU -> dropout -> lin2_i ->
  MaxK/ReLU; x = relu(x_res + x) -> dropout] -> lin_out.

Parameter names match the flax ones (``lin_in``, ``fc_self_{i}``,
``fc_neigh_{i}``, ``lin_{i}``, ``gconv_bias_{i}``, ``gin_eps_{i}``,
``res_{i}``, ``lin1_{i}``, ``lin2_{i}``, ``norm_{i}``, ``lin_out``), and
GNNRes's BatchNorm keeps flax's ``batch_stats`` as running buffers, so
weights carry across (``models/convert.py``). flax's defaults are set
explicitly: LayerNorm eps 1e-6, BatchNorm momentum 0.99 and eps 1e-5,
xavier-uniform weights and zero biases. MaxK runs on K1 and every
aggregation on K2 (``ops/maxk.py``, ``ops/spmm.py``), or on K7 under
``compute_dtype="int8"``, as in the JAX models; "int8_rowscale" is
refused (TypeError), as ``jnp.dtype`` refuses it there.

Graphs are call-time arguments (a ``GraphBundle``), never parameters.
On a rank of row-partitioned training (``maxk_tpu_torch/parallel/``) the
bundle holds the rank's row shards, whose ops exchange rows themselves,
and GNNRes's BatchNorm sums its statistics over the ranks. Under tensor
parallelism ``parallel/tensor.py::shard_model`` makes every Linear of a
built model column-parallel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from maxk_tpu_torch import obs
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR, resolve_device
from maxk_tpu_torch.ops.maxk import maxk
from maxk_tpu_torch.ops.spgemm import maxk_spgemm, uses_cbsr
from maxk_tpu_torch.ops.spmm import INT8_ROWSCALE, spmm_t
from maxk_tpu_torch.parallel.mesh import GraphGroup, all_reduce_sum

# Aggregations each model family consumes.
MODEL_NORMS = {"sage": ("mean",), "sage_fused": ("mean",),
               "gcn": ("sym",), "gin": ("sum",), "gnn_res": ("sym",)}


@dataclasses.dataclass(frozen=True)
class GraphBundle:
    """Device CSRs for every aggregation a model family may need.

    g_mean/g_sum/g_sym carry mean-, un- and symmetric-normalized edge
    values; *_t are the matching transposes, used by every backward.
    n_valid: on a row shard, how many of its rows are real nodes (the
    rest pad the last shard); None: all.
    """

    g_mean: Optional[DeviceCSR] = None
    g_mean_t: Optional[DeviceCSR] = None
    g_sum: Optional[DeviceCSR] = None
    g_sum_t: Optional[DeviceCSR] = None
    g_sym: Optional[DeviceCSR] = None
    g_sym_t: Optional[DeviceCSR] = None
    n_valid: Optional[int] = None

    @staticmethod
    def from_csr(csr: CSRGraph, norms=("mean", "sum", "sym"),
                 symmetric: bool = False, device=None,
                 hub_cols: Optional[int] = None) -> "GraphBundle":
        """symmetric=True asserts A == A^T including edge values. Then the
        sum/sym matrices are their own transpose (shared, not rebuilt),
        and the mean transpose (D^-1 A)^T = A D^-1 keeps A's structure:
        a column-degree rescale of the values instead of a transpose,
        sharing A's device arrays and segment plan. Under a hub split
        (``hub_cols``, ``DeviceCSR.from_csr``'s knob) the slab holds A's
        values, so the mean transpose is built from the rescaled CSR
        instead, as the JAX package builds it."""
        device = resolve_device(device)

        def build(c: CSRGraph) -> DeviceCSR:
            return DeviceCSR.from_csr(c, device, hub_cols=hub_cols)

        built = {}
        for norm in norms:
            with obs.phase("build.normalize"):
                base = csr.normalize("none" if norm == "sum" else norm)
                mean_t = mean_transpose_values(csr) \
                    if symmetric and norm == "mean" else None
            g = built[f"g_{norm}"] = build(base)
            if symmetric and norm in ("sum", "sym"):
                t = g
            elif mean_t is not None and g.hub_ids is None:
                with obs.phase("build.upload"):
                    t = dataclasses.replace(
                        g, values=torch.from_numpy(mean_t).to(device))
            elif mean_t is not None:
                t = build(csr.with_values(mean_t))
            else:
                with obs.phase("build.transpose"):
                    base_t = base.transpose()
                t = build(base_t)
            built[f"g_{norm}_t"] = t
        return GraphBundle(**built)

    @staticmethod
    def for_model(csr: CSRGraph, model_name: str, symmetric: bool = False,
                  device=None) -> "GraphBundle":
        """Build only the aggregation(s) `model_name` consumes."""
        return GraphBundle.from_csr(
            csr, norms=MODEL_NORMS.get(model_name, ("mean", "sum", "sym")),
            symmetric=symmetric, device=device)


def mean_transpose_values(csr: CSRGraph) -> np.ndarray:
    """Edge values of (D^-1 A)^T = A D^-1 for a symmetric A, in A's
    structure: each edge's value over its column's degree."""
    deg = np.maximum(np.diff(csr.indptr), 1).astype(np.float32)
    return (csr.values / deg[csr.indices]).astype(np.float32)


def _linear(n_in: int, n_out: int, bias: bool,
            generator: torch.Generator) -> nn.Linear:
    """flax Dense init: xavier-uniform kernel, zero bias."""
    lin = nn.Linear(n_in, n_out, bias=bias)
    with torch.no_grad():
        nn.init.xavier_uniform_(lin.weight, generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax Dropout: keep with probability 1 - p, scale kept by 1/(1-p);
    the bits come from an explicit generator on x's device."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class _BatchNorm(torch.autograd.Function):
    """BatchNorm's training pass: normalise with the batch's statistics,
    move the running ones, and differentiate through the statistics with
    the gradient written out.

    The statistics are E[x] and E[x^2] over the first ``n_valid`` rows
    (None: all), with a ``group`` summed over its ranks with the row
    count; var = clamp(E[x^2] - E[x]^2, 0); y = xhat * w + b with xhat =
    (x - mean) * rstd, rstd = rsqrt(var + eps). Only xhat and rstd are
    kept for the backward:

        db = sum(dy), dw = sum(dy * xhat) (this rank's rows),
        dx = rstd * w * (dy - mean(dy) - xhat * mean(dy * xhat))

    on the rows that fed the statistics, and rstd * w * dy past them. The
    two means sum every row the statistics normalised (a padded row's y
    depends on them too) and divide by the statistics' row count; with a
    group the sums are all-reduced, the backward's one collective. Where
    the clamp binds, the variance passes no gradient, as autograd's clamp
    passes none, and the xhat term drops out.

    Full passes over the (V, D) tensor: the forward reads 5 and writes 3
    (x for each sum, x - mean, its scaling in place, y), the backward
    reads 7 and writes 3 (dy's sum, dy * xhat and its sum, the direct
    term, the correction in place).
    """

    @staticmethod
    def forward(ctx, x, weight, bias, bn, n_valid):
        xv = x[:n_valid]
        s1 = xv.sum(dim=0)
        # sum(x^2) as the squared column norm: one read, no temporary.
        s2 = torch.linalg.vector_norm(xv, dim=0).square()
        d = x.shape[1]
        if bn.group is None:
            n = float(xv.shape[0])
            mean, mean2 = s1 / n, s2 / n
        else:
            count = torch.full((1,), float(xv.shape[0]), dtype=x.dtype,
                               device=x.device)
            sums = all_reduce_sum(torch.cat([s1, s2, count]), bn.group)
            n = sums[-1]
            mean, mean2 = sums[:d] / n, sums[d:2 * d] / n
        raw_var = mean2 - mean * mean
        var = torch.clamp(raw_var, min=0.0)
        rstd = torch.rsqrt(var + bn.eps)
        m = bn.momentum
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
        obs.count("norm.updates")
        xhat = torch.sub(x, mean).mul_(rstd)
        ctx.save_for_backward(xhat, rstd, weight, raw_var >= 0.0)
        ctx.n, ctx.n_valid, ctx.group = n, n_valid, bn.group
        return torch.addcmul(bias, xhat, weight)

    @staticmethod
    def backward(ctx, dy):
        with obs.span("maxk.norm.backward"):
            xhat, rstd, weight, var_moves = ctx.saved_tensors
            db = dy.sum(dim=0)
            dw = (dy * xhat).sum(dim=0)
            s_dy, s_dyx = db, dw
            if ctx.group is not None:
                d = dy.shape[1]
                sums = all_reduce_sum(torch.cat([db, dw]), ctx.group)
                s_dy, s_dyx = sums[:d], sums[d:]
            scale = rstd * weight
            dx = torch.addcmul(-scale * (s_dy / ctx.n), dy, scale)
            dx.addcmul_(xhat, torch.where(var_moves, -scale * (s_dyx / ctx.n),
                                          0.0))
            if ctx.n_valid is not None and ctx.n_valid < dy.shape[0]:
                dx[ctx.n_valid:] = dy[ctx.n_valid:] * scale
        return dx, dw, db, None, None


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the node axis, with flax's statistics.

    Training normalises with the batch's biased statistics, the variance
    as flax computes it (E[x^2] - E[x]^2, clamped at 0), and moves the
    running ones by ``running = momentum * running + (1 - momentum) *
    batch``; eval normalises with the running ones. torch's
    ``BatchNorm1d`` would update the running variance with the unbiased
    batch variance and weigh the new value by its momentum, so it is not
    used. Running mean starts at 0 and running variance at 1. Training
    runs in one autograd op, ``_BatchNorm``, with its own backward.

    With a ``group`` (the JAX package's ``bn_axis``) the batch is every
    rank's rows: training all-reduces sum(x), sum(x^2) and the row count
    (the first ``n_valid`` rows of each rank: padded rows do not count,
    where the JAX package lets them in), and the backward all-reduces the
    two sums its correction needs.
    """

    momentum = 0.99
    eps = 1e-5

    def __init__(self, n: int, group: Optional[GraphGroup] = None):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor, training: bool,
                n_valid: Optional[int] = None) -> torch.Tensor:
        with obs.span("maxk.norm.forward"):
            if training:
                return _BatchNorm.apply(x, self.weight, self.bias, self,
                                        n_valid)
            scale = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean) * scale + self.bias


class _GNN(nn.Module):
    """What every model family shares: the reference's constructor
    settings, the nonlinearity, and loading flax weights."""

    def __init__(self, num_hid_layers: int, maxk: int, feat_drop: float,
                 norm: bool, nonlinear: str, compute_dtype: str):
        super().__init__()
        if nonlinear not in ("maxk", "relu"):
            raise ValueError(f"unknown nonlinearity {nonlinear!r}")
        if compute_dtype == INT8_ROWSCALE:
            # The JAX model's jnp.dtype("int8_rowscale") fails the same
            # way; the mode is reached through maxk_spgemm.
            raise TypeError("compute_dtype 'int8_rowscale' is not a model "
                            "dtype; pass it to maxk_spgemm or "
                            "spgemm_forward_cbsr")
        self.num_hid_layers = num_hid_layers
        self.maxk = maxk
        self.feat_drop = feat_drop
        self.norm = norm
        self.nonlinear = nonlinear
        self.compute_dtype = compute_dtype

    def _nonlinear(self, x: torch.Tensor) -> torch.Tensor:
        return maxk(x, self.maxk) if self.nonlinear == "maxk" \
            else torch.relu(x)

    def load_flax_params(self, params, batch_stats=None) -> None:
        """Load a flax model's ``params`` tree (nested dicts of arrays)
        and, where it has one, its ``batch_stats`` collection. Without
        ``batch_stats`` the running statistics stay as they are. A model
        made column-parallel (``parallel/tensor.py::shard_model``) takes
        its own columns of each kernel."""
        from maxk_tpu_torch.models.convert import params_from_flax
        state = params_from_flax(params, batch_stats,
                                 shard=getattr(self, "tp_shard", None))
        if batch_stats is None:
            state.update({key: buf for key, buf in self.named_buffers()})
        self.load_state_dict(state, strict=True)


class SAGE(_GNN):
    """GraphSAGE with MaxK aggregation (fc_self sees the post-MaxK x)."""

    def __init__(self, in_size: int, hid_size: int, num_hid_layers: int,
                 out_size: int, maxk: int = 32, feat_drop: float = 0.5,
                 norm: bool = False, nonlinear: str = "maxk",
                 compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_hid_layers, maxk, feat_drop, norm, nonlinear,
                         compute_dtype)
        gen = generator if generator is not None else torch.Generator()
        # Registration order is flax's creation order.
        self.lin_in = _linear(in_size, hid_size, True, gen)
        for i in range(num_hid_layers):
            self.add_module(f"fc_self_{i}",
                            _linear(hid_size, hid_size, False, gen))
            self.add_module(f"fc_neigh_{i}",
                            _linear(hid_size, hid_size, False, gen))
            if norm:
                self.add_module(f"norm_{i}", nn.LayerNorm(hid_size, eps=1e-6))
        self.lin_out = _linear(hid_size, out_size, True, gen)

    def _aggregate(self, graphs: GraphBundle, x: torch.Tensor):
        """(x for fc_self, x_agg for fc_neigh)."""
        if self.nonlinear == "maxk":
            # The JAX model runs maxk_spgemm(x) and maxk(x) side by side,
            # both on the pre-MaxK x. On the CBSR route (and on a row
            # shard, where CBSR is the wire) so does this one.
            # On the mask route both apply the same mask to the same x
            # (forward x * mask, backward g * mask), so one MaxK feeding
            # both branches computes the same values and gradients with
            # one K1 launch.
            if uses_cbsr(graphs.g_mean, self.compute_dtype):
                return (maxk(x, self.maxk),
                        maxk_spgemm(graphs.g_mean, graphs.g_mean_t, x,
                                    self.maxk, self.compute_dtype))
            x = maxk(x, self.maxk)
        else:
            x = torch.relu(x)
        return x, spmm_t(graphs.g_mean, graphs.g_mean_t, x,
                         self.compute_dtype)

    def forward(self, graphs: GraphBundle, x: torch.Tensor, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.lin_in(x)
        for i in range(self.num_hid_layers):
            x, x_agg = self._aggregate(graphs, x)
            x = (getattr(self, f"fc_self_{i}")(x)
                 + getattr(self, f"fc_neigh_{i}")(x_agg))
            x = dropout(x, self.feat_drop, training, generator)
            if self.norm:
                x = getattr(self, f"norm_{i}")(x)
        return self.lin_out(x)


class SAGEFused(SAGE):
    """SAGE with fc_self on the pre-MaxK x and the aggregation through the
    fused maxk_spgemm."""

    def _aggregate(self, graphs: GraphBundle, x: torch.Tensor):
        if self.nonlinear == "maxk":
            return x, maxk_spgemm(graphs.g_mean, graphs.g_mean_t, x,
                                  self.maxk, self.compute_dtype)
        return super()._aggregate(graphs, x)


class GCN(_GNN):
    """GCN: each layer is Linear -> MaxK/ReLU -> dropout -> GraphConv on
    the sym-normalised graph (dgl's GraphConv(weight=None, bias=True))
    -> LayerNorm?"""

    def __init__(self, in_size: int, hid_size: int, num_hid_layers: int,
                 out_size: int, maxk: int = 32, feat_drop: float = 0.5,
                 norm: bool = False, nonlinear: str = "maxk",
                 compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_hid_layers, maxk, feat_drop, norm, nonlinear,
                         compute_dtype)
        gen = generator if generator is not None else torch.Generator()
        # Registration order is flax's creation order.
        self.lin_in = _linear(in_size, hid_size, True, gen)
        for i in range(num_hid_layers):
            self.add_module(f"lin_{i}", _linear(hid_size, hid_size, True, gen))
            self._add_conv_param(i, hid_size)
            if norm:
                self.add_module(f"norm_{i}", nn.LayerNorm(hid_size, eps=1e-6))
        self.lin_out = _linear(hid_size, out_size, True, gen)

    def _add_conv_param(self, i: int, hid_size: int) -> None:
        self.register_parameter(f"gconv_bias_{i}",
                                nn.Parameter(torch.zeros(hid_size)))

    def _conv(self, graphs: GraphBundle, x: torch.Tensor,
              i: int) -> torch.Tensor:
        return (spmm_t(graphs.g_sym, graphs.g_sym_t, x, self.compute_dtype)
                + getattr(self, f"gconv_bias_{i}"))

    def forward(self, graphs: GraphBundle, x: torch.Tensor, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.lin_in(x))
        for i in range(self.num_hid_layers):
            x = self._nonlinear(getattr(self, f"lin_{i}")(x))
            x = dropout(x, self.feat_drop, training, generator)
            x = self._conv(graphs, x, i)
            if self.norm:
                x = getattr(self, f"norm_{i}")(x)
        return self.lin_out(x)


class GIN(GCN):
    """GIN: GCN's shell with dgl's GINConv(learn_eps=True):
    (1 + eps_i) x + the sum over neighbours."""

    def _add_conv_param(self, i: int, hid_size: int) -> None:
        self.register_parameter(f"gin_eps_{i}",
                                nn.Parameter(torch.zeros(())))

    def _conv(self, graphs: GraphBundle, x: torch.Tensor,
              i: int) -> torch.Tensor:
        eps = getattr(self, f"gin_eps_{i}")
        return (1.0 + eps) * x + spmm_t(graphs.g_sum, graphs.g_sum_t, x,
                                        self.compute_dtype)


class GNNRes(_GNN):
    """Residual GCN blocks: x_res = res_i(x); GraphConv (sym) + bias ->
    BatchNorm? -> lin1_i -> ReLU -> dropout -> lin2_i -> MaxK/ReLU;
    x = relu(x_res + x) -> dropout. With a ``group`` the BatchNorm
    statistics are the ranks' together."""

    def __init__(self, in_size: int, hid_size: int, num_hid_layers: int,
                 out_size: int, maxk: int = 32, feat_drop: float = 0.5,
                 norm: bool = False, nonlinear: str = "maxk",
                 compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None,
                 group: Optional[GraphGroup] = None):
        super().__init__(num_hid_layers, maxk, feat_drop, norm, nonlinear,
                         compute_dtype)
        gen = generator if generator is not None else torch.Generator()
        # Registration order is flax's creation order.
        self.lin_in = _linear(in_size, hid_size, True, gen)
        for i in range(num_hid_layers):
            self.add_module(f"res_{i}", _linear(hid_size, hid_size, True, gen))
            self.register_parameter(f"gconv_bias_{i}",
                                    nn.Parameter(torch.zeros(hid_size)))
            if norm:
                self.add_module(f"norm_{i}", BatchNorm(hid_size, group))
            self.add_module(f"lin1_{i}",
                            _linear(hid_size, hid_size, True, gen))
            self.add_module(f"lin2_{i}",
                            _linear(hid_size, hid_size, True, gen))
        self.lin_out = _linear(hid_size, out_size, True, gen)

    def forward(self, graphs: GraphBundle, x: torch.Tensor, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.lin_in(x))
        for i in range(self.num_hid_layers):
            x_res = getattr(self, f"res_{i}")(x)
            x = (spmm_t(graphs.g_sym, graphs.g_sym_t, x, self.compute_dtype)
                 + getattr(self, f"gconv_bias_{i}"))
            if self.norm:
                x = getattr(self, f"norm_{i}")(x, training, graphs.n_valid)
            x = torch.relu(getattr(self, f"lin1_{i}")(x))
            x = dropout(x, self.feat_drop, training, generator)
            x = self._nonlinear(getattr(self, f"lin2_{i}")(x))
            x = torch.relu(x_res + x)
            x = dropout(x, self.feat_drop, training, generator)
        return self.lin_out(x)


_MODELS = {"sage": SAGE, "sage_fused": SAGEFused, "gcn": GCN, "gin": GIN,
           "gnn_res": GNNRes}


def build_model(name: str, in_size: int, hid_size: int, num_hid_layers: int,
                out_size: int, maxk: int = 32, feat_drop: float = 0.5,
                norm: bool = False, nonlinear: str = "maxk",
                compute_dtype: str = "bfloat16",
                generator: Optional[torch.Generator] = None,
                group: Optional[GraphGroup] = None) -> nn.Module:
    """Model switch of the trainers. ``group``: the ranks of
    row-partitioned training, whose BatchNorm statistics GNNRes with
    norm sums (the JAX package's ``bn_axis``)."""
    try:
        cls = _MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; choose from {sorted(_MODELS)}") from None
    kwargs = {"group": group} if cls is GNNRes else {}
    return cls(in_size, hid_size, num_hid_layers, out_size, maxk=maxk,
               feat_drop=feat_drop, norm=norm, nonlinear=nonlinear,
               compute_dtype=compute_dtype, generator=generator, **kwargs)
