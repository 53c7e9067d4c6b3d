"""The benchmark's graph and node data, made on the device from a seed.

``make_graph`` draws a simple undirected graph with an exact edge count
and a heavy-tailed degree profile (Chung-Lu: each endpoint is drawn with
probability proportional to its node's weight, self-pairs are dropped,
duplicate pairs merged, and the draw is topped up until it holds exactly
the published number of pairs). The weights are the quantiles of a
truncated power law ``p(w) ~ w**-exponent`` whose largest over its mean is
the published largest degree over the mean degree, so every seed gets the
same expected degree profile and the seed only chooses which node gets
which weight and which edges are drawn. Node ids are in random order.

``make_nodes`` draws N(0, 1) features, uniform labels and disjoint train,
val and test masks of the published sizes. Everything runs in a few large
torch calls on one ``torch.Generator`` of the target device.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class Graph:
    """A symmetric CSR graph: rows sorted, columns sorted within rows."""

    indptr: torch.Tensor    # (V+1,) int64
    indices: torch.Tensor   # (E,)   int64
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> torch.Tensor:
        return torch.diff(self.indptr)


def _ratio_for(mean_ratio: float, exponent: float) -> float:
    """b/a of a power law on [a, b] with exponent ``exponent`` whose b over
    its mean is ``mean_ratio``, by bisection on log(b/a)."""
    def max_over_mean(r: float) -> float:
        if abs(exponent - 2.0) < 1e-9:
            return (r - 1.0) / math.log(r)
        g = exponent
        # mean / a = (g-1)/(g-2) * (1 - r**(2-g)) / (1 - r**(1-g))
        mean_over_a = ((g - 1) / (g - 2) * (1 - r ** (2 - g))
                       / (1 - r ** (1 - g)))
        return r / mean_over_a

    lo, hi = 1e-6, 60.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if max_over_mean(math.exp(mid)) < mean_ratio:
            lo = mid
        else:
            hi = mid
    return math.exp(0.5 * (lo + hi))


def degree_profile(n_nodes: int, max_over_mean: float, exponent: float,
                   device) -> torch.Tensor:
    """(V,) float64 weights of mean 1, largest first: the quantiles
    (i + 1/2) / V of a power law truncated to [a, b], b / mean =
    ``max_over_mean``."""
    r = _ratio_for(max_over_mean, exponent)
    a, b = 1.0, r
    q = (torch.arange(n_nodes, dtype=torch.float64, device=device) + 0.5) \
        / n_nodes
    g = exponent
    # Inverse CDF of p(w) ~ w**-g on [a, b], taken from the top.
    lo, hi = a ** (1 - g), b ** (1 - g)
    w = (hi + q * (lo - hi)) ** (1.0 / (1 - g))
    return w / w.mean()


def make_graph(n_nodes: int, n_edges: int, max_degree: float,
               exponent: float, gen: torch.Generator) -> Graph:
    """A simple symmetric graph of ``n_nodes`` nodes and ``n_edges``
    directed edges (``n_edges / 2`` undirected pairs), no self-loops."""
    if n_edges % 2:
        raise ValueError(f"a symmetric graph has an even number of directed "
                         f"edges, got {n_edges}")
    device = gen.device
    n, m = n_nodes, n_edges // 2
    if m > n * (n - 1) // 2:
        raise ValueError(f"{m} pairs do not fit in {n} nodes")
    w = degree_profile(n, max_degree / (n_edges / n), exponent, device)
    weights = torch.empty_like(w)
    weights[torch.randperm(n, generator=gen, device=device)] = w
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < m:
        draw = int((m - keys.numel()) * 1.05) + 1024
        ends = torch.searchsorted(
            cdf, torch.rand(2, draw, generator=gen, device=device,
                            dtype=torch.float64))
        ends.clamp_(max=n - 1)
        u, v = ends[0], ends[1]
        keep = u != v
        lo, hi = torch.minimum(u, v)[keep], torch.maximum(u, v)[keep]
        keys = torch.unique(torch.cat([keys, lo * n + hi]))
    if keys.numel() > m:
        pick = torch.randperm(keys.numel(), generator=gen, device=device)[:m]
        keys = torch.sort(keys[pick]).values
    lo, hi = keys // n, keys % n
    del keys
    return csr_from_pairs(torch.cat([lo, hi]), torch.cat([hi, lo]), n)


def csr_from_pairs(src: torch.Tensor, dst: torch.Tensor,
                   n_nodes: int) -> Graph:
    """CSR of the directed edges src -> dst, columns sorted in each row."""
    order = torch.argsort(src * n_nodes + dst)
    indices = dst[order]
    counts = torch.bincount(src, minlength=n_nodes)
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return Graph(indptr, indices, n_nodes)


def add_self_loops(g: Graph) -> Graph:
    """The graph with an edge i -> i added to every node (which has none)."""
    n = g.n_nodes
    rows = torch.repeat_interleave(
        torch.arange(n, device=g.indptr.device), g.degrees())
    loop = torch.arange(n, device=g.indptr.device)
    return csr_from_pairs(torch.cat([rows, loop]),
                          torch.cat([g.indices, loop]), n)


@dataclasses.dataclass
class Nodes:
    features: torch.Tensor     # (V, F) float32
    labels: torch.Tensor       # (V,)   int64
    train_mask: torch.Tensor   # (V,)   bool
    val_mask: torch.Tensor
    test_mask: torch.Tensor


def make_nodes(n_nodes: int, n_features: int, n_classes: int,
               split: tuple[int, int, int], gen: torch.Generator) -> Nodes:
    """N(0, 1) features, uniform labels, and disjoint train, val and test
    masks of ``split`` nodes each, drawn at random."""
    if sum(split) != n_nodes:
        raise ValueError(f"split {split} does not cover {n_nodes} nodes")
    device = gen.device
    features = torch.randn(n_nodes, n_features, generator=gen, device=device)
    labels = torch.randint(0, n_classes, (n_nodes,), generator=gen,
                           device=device)
    perm = torch.randperm(n_nodes, generator=gen, device=device)
    masks = []
    start = 0
    for size in split:
        m = torch.zeros(n_nodes, dtype=torch.bool, device=device)
        m[perm[start:start + size]] = True
        masks.append(m)
        start += size
    return Nodes(features, labels, *masks)
