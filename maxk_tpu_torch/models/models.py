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
aggregation on K2 (``ops/maxk.py``, ``ops/spmm.py``).

Graphs are call-time arguments (a ``GraphBundle``), never parameters.
On a rank of row-partitioned training (``maxk_tpu_torch/parallel/``) the
bundle holds the rank's row shards, whose ops exchange rows themselves,
and GNNRes's BatchNorm sums its statistics over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR, resolve_device
from maxk_tpu_torch.ops.maxk import maxk
from maxk_tpu_torch.ops.spgemm import maxk_spgemm, uses_cbsr
from maxk_tpu_torch.ops.spmm import spmm_t
from maxk_tpu_torch.parallel.mesh import GraphGroup, all_reduce_sum_grad

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
                 symmetric: bool = False, device=None) -> "GraphBundle":
        """symmetric=True asserts A == A^T including edge values. Then the
        sum/sym matrices are their own transpose (shared, not rebuilt),
        and the mean transpose (D^-1 A)^T = A D^-1 keeps A's structure:
        a column-degree rescale of the values instead of a transpose,
        sharing A's device arrays and segment plan."""
        device = resolve_device(device)
        built = {}
        for norm in norms:
            base = csr.normalize("none" if norm == "sum" else norm)
            built[f"g_{norm}"] = DeviceCSR.from_csr(base, device)
            if symmetric and norm in ("sum", "sym"):
                t = built[f"g_{norm}"]
            elif symmetric and norm == "mean":
                t = dataclasses.replace(
                    built[f"g_{norm}"], values=torch.from_numpy(
                        mean_transpose_values(csr)).to(device))
            else:
                t = DeviceCSR.from_csr(base.transpose(), device)
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


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the node axis, with flax's statistics.

    Training normalises with the batch's biased statistics, the variance
    as flax computes it (E[x^2] - E[x]^2, clamped at 0), and moves the
    running ones by ``running = momentum * running + (1 - momentum) *
    batch``; eval normalises with the running ones. torch's
    ``BatchNorm1d`` would update the running variance with the unbiased
    batch variance and weigh the new value by its momentum, so it is not
    used. Running mean starts at 0 and running variance at 1.

    With a ``group`` (the JAX package's ``bn_axis``) the batch is every
    rank's rows: training all-reduces sum(x), sum(x^2) and the row count
    (the first ``n_valid`` rows of each rank: padded rows do not count,
    where the JAX package lets them in), and the gradient flows back
    through the sum.
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

    def _moments(self, x: torch.Tensor, n_valid: Optional[int]):
        """E[x] and E[x^2] over the batch."""
        if self.group is None:
            return x.mean(dim=0), (x * x).mean(dim=0)
        xv = x[:n_valid]
        n = torch.full((1,), float(xv.shape[0]), dtype=x.dtype,
                       device=x.device)
        sums = all_reduce_sum_grad(
            torch.cat([xv.sum(dim=0), (xv * xv).sum(dim=0), n]), self.group)
        d = x.shape[1]
        return sums[:d] / sums[-1], sums[d:2 * d] / sums[-1]

    def forward(self, x: torch.Tensor, training: bool,
                n_valid: Optional[int] = None) -> torch.Tensor:
        if training:
            mean, mean2 = self._moments(x, n_valid)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class _GNN(nn.Module):
    """What every model family shares: the reference's constructor
    settings, the nonlinearity, and loading flax weights."""

    def __init__(self, num_hid_layers: int, maxk: int, feat_drop: float,
                 norm: bool, nonlinear: str, compute_dtype: str):
        super().__init__()
        if nonlinear not in ("maxk", "relu"):
            raise ValueError(f"unknown nonlinearity {nonlinear!r}")
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
        ``batch_stats`` the running statistics stay as they are."""
        from maxk_tpu_torch.models.convert import params_from_flax
        state = params_from_flax(params, batch_stats)
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
            if uses_cbsr(graphs.g_mean):
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
