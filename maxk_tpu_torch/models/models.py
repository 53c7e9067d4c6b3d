"""GNN models on the port's ops: SAGE and SAGEFused.

Same semantics as the JAX package's flax models, written as
``nn.Module``s: lin_in -> per layer [MaxK (or ReLU) -> mean-neighbour
aggregation; h = fc_self(x) + fc_neigh(x_agg); dropout; LayerNorm?] ->
lin_out. Parameter names match the flax ones (``lin_in``,
``fc_self_{i}``, ``fc_neigh_{i}``, ``norm_{i}``, ``lin_out``) so weights
carry across (``models/convert.py``). flax's defaults are set
explicitly: LayerNorm eps 1e-6, xavier-uniform weights and zero biases.

Graphs are call-time arguments (a ``GraphBundle``), never parameters.
GCN, GIN and GNN_res are not ported yet (ROADMAP slice 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR, resolve_device
from maxk_tpu_torch.ops.maxk import maxk
from maxk_tpu_torch.ops.spgemm import maxk_spgemm
from maxk_tpu_torch.ops.spmm import spmm_t

# Aggregations each model family consumes.
MODEL_NORMS = {"sage": ("mean",), "sage_fused": ("mean",),
               "gcn": ("sym",), "gin": ("sum",), "gnn_res": ("sym",)}


@dataclasses.dataclass(frozen=True)
class GraphBundle:
    """Device CSRs for every aggregation a model family may need.

    g_mean/g_sum/g_sym carry mean-, un- and symmetric-normalized edge
    values; *_t are the matching transposes, used by every backward.
    """

    g_mean: Optional[DeviceCSR] = None
    g_mean_t: Optional[DeviceCSR] = None
    g_sum: Optional[DeviceCSR] = None
    g_sum_t: Optional[DeviceCSR] = None
    g_sym: Optional[DeviceCSR] = None
    g_sym_t: Optional[DeviceCSR] = None

    @staticmethod
    def from_csr(csr: CSRGraph, norms=("mean", "sum", "sym"),
                 symmetric: bool = False, device=None) -> "GraphBundle":
        """symmetric=True asserts A == A^T including edge values. Then the
        sum/sym matrices are their own transpose (shared, not rebuilt),
        and the mean transpose (D^-1 A)^T = A D^-1 keeps A's structure:
        a column-degree rescale of the values instead of a transpose."""
        device = resolve_device(device)
        built = {}
        for norm in norms:
            base = csr.normalize("none" if norm == "sum" else norm)
            built[f"g_{norm}"] = DeviceCSR.from_csr(base, device)
            if symmetric and norm in ("sum", "sym"):
                t = built[f"g_{norm}"]
            elif symmetric and norm == "mean":
                deg = np.maximum(np.diff(csr.indptr), 1).astype(np.float32)
                t = DeviceCSR.from_csr(csr.with_values(
                    (csr.values / deg[csr.indices]).astype(np.float32)),
                    device)
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


class SAGE(nn.Module):
    """GraphSAGE with MaxK aggregation (fc_self sees the post-MaxK x)."""

    def __init__(self, in_size: int, hid_size: int, num_hid_layers: int,
                 out_size: int, maxk: int = 32, feat_drop: float = 0.5,
                 norm: bool = False, nonlinear: str = "maxk",
                 compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if nonlinear not in ("maxk", "relu"):
            raise ValueError(f"unknown nonlinearity {nonlinear!r}")
        gen = generator if generator is not None else torch.Generator()
        self.num_hid_layers = num_hid_layers
        self.maxk = maxk
        self.feat_drop = feat_drop
        self.norm = norm
        self.nonlinear = nonlinear
        self.compute_dtype = compute_dtype
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
            # The JAX model runs maxk_spgemm(x) and maxk(x) side by side.
            # Both apply the same mask to the same x (forward x * mask,
            # backward g * mask), so one MaxK feeding both branches
            # computes the same values and gradients with one K1 launch.
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

    def load_flax_params(self, params) -> None:
        """Load a flax SAGE's params tree (nested dicts of arrays)."""
        from maxk_tpu_torch.models.convert import params_from_flax
        self.load_state_dict(params_from_flax(params), strict=True)


class SAGEFused(SAGE):
    """SAGE with fc_self on the pre-MaxK x and the aggregation through the
    fused maxk_spgemm."""

    def _aggregate(self, graphs: GraphBundle, x: torch.Tensor):
        if self.nonlinear == "maxk":
            return x, maxk_spgemm(graphs.g_mean, graphs.g_mean_t, x,
                                  self.maxk, self.compute_dtype)
        return super()._aggregate(graphs, x)


_MODELS = {"sage": SAGE, "sage_fused": SAGEFused}


def build_model(name: str, in_size: int, hid_size: int, num_hid_layers: int,
                out_size: int, maxk: int = 32, feat_drop: float = 0.5,
                norm: bool = False, nonlinear: str = "maxk",
                compute_dtype: str = "bfloat16",
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Model switch of the training driver."""
    if name in ("gcn", "gin", "gnn_res"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP slice 2")
    try:
        cls = _MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; choose from "
            f"{sorted(_MODELS) + ['gcn', 'gin', 'gnn_res']}") from None
    return cls(in_size, hid_size, num_hid_layers, out_size, maxk=maxk,
               feat_drop=feat_drop, norm=norm, nonlinear=nonlinear,
               compute_dtype=compute_dtype, generator=generator)
