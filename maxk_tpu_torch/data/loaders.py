"""Graph IO: binary CSR files (wire-compatible with the reference's
24-graph kernel benchmark suite) and synthetic graph generation.

The reference reads graphs as raw little-endian int32 arrays from
``<name>.indptr`` / ``<name>.indices`` files (reference kernels/util.h:8-24,
kernels/main.cu:56-71, base_dir ``kernels/graphs/``). The same format is
read and written here so existing graph dumps work unchanged.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from maxk_tpu_torch.ops.graph import CSRGraph


def load_csr_binary(base_dir: str | os.PathLike, name: str) -> CSRGraph:
    """Load ``<base_dir>/<name>.indptr`` + ``.indices`` (int32 LE)."""
    base = Path(base_dir)
    stem = name[: -len(".indptr")] if name.endswith(".indptr") else name
    indptr = np.fromfile(base / f"{stem}.indptr", dtype=np.int32)
    indices = np.fromfile(base / f"{stem}.indices", dtype=np.int32)
    if indptr.size == 0 or indptr[0] != 0 or int(indptr[-1]) != indices.size:
        raise ValueError(
            f"corrupt CSR files for {stem!r}: indptr[0]={indptr[:1]}, "
            f"indptr[-1]={indptr[-1:]}, n_edges={indices.size}")
    return CSRGraph(indptr.astype(np.int64), indices)


def save_csr_binary(csr: CSRGraph, base_dir: str | os.PathLike,
                    name: str) -> None:
    base = Path(base_dir)
    base.mkdir(parents=True, exist_ok=True)
    csr.indptr.astype(np.int32).tofile(base / f"{name}.indptr")
    csr.indices.astype(np.int32).tofile(base / f"{name}.indices")


def available_graphs(base_dir: str | os.PathLike) -> list[str]:
    """All graph names with an .indptr file, sorted (the reference's
    all-graph traversal, kernels/main.cu:207-218)."""
    base = Path(base_dir)
    if not base.is_dir():
        return []
    return sorted(p.name[: -len(".indptr")]
                  for p in base.glob("*.indptr"))


def rmat_graph(n_nodes: int, avg_degree: float, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               symmetric: bool = True) -> CSRGraph:
    """R-MAT graph (Chakrabarti et al.; Graph500 defaults a/b/c/d =
    .57/.19/.19/.05).

    Structurally distinct second generator: the recursive quadrant
    construction yields community structure and src/dst-correlated
    locality that the uniform power-law generator (synthetic_graph)
    lacks. Bit-equal to maxk_tpu.data.loaders.rmat_graph.
    """
    rng = np.random.default_rng(seed)
    n_edges = int(n_nodes * avg_degree)
    levels = max(1, int(np.ceil(np.log2(max(2, n_nodes)))))
    d_q = 1.0 - a - b - c
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    # One categorical quadrant draw per level, with +-10% per-edge mass
    # noise (standard R-MAT smoothing against exact self-similarity).
    # Quadrants: a = (src0,dst0), b = (src0,dst1), c = (src1,dst0),
    # d = (src1,dst1).
    for _ in range(levels):
        jit = 1.0 + 0.1 * (rng.uniform(size=(4, n_edges)) - 0.5)
        pa, pb, pc, pd = a * jit[0], b * jit[1], c * jit[2], d_q * jit[3]
        u = rng.uniform(size=n_edges) * (pa + pb + pc + pd)
        bottom = u >= pa + pb
        right = np.where(bottom, u >= pa + pb + pc, u >= pa)
        src = (src << 1) | bottom.astype(np.int64)
        dst = (dst << 1) | right.astype(np.int64)
    # Fold the 2^levels id space onto [0, n_nodes).
    src %= n_nodes
    dst %= n_nodes
    if symmetric:
        src, dst = (np.concatenate([src, dst]),
                    np.concatenate([dst, src]))
    return CSRGraph.from_coo(src, dst.astype(np.int32), n_nodes)


def synthetic_graph(n_nodes: int, avg_degree: float, seed: int = 0,
                    power_law: bool = True, symmetric: bool = True,
                    self_loops: bool = False) -> CSRGraph:
    """Seeded synthetic graph with a power-law-ish degree profile.

    Used for tests, the benchmark harness when the 24-graph suite is not on
    disk, and the synthetic training dataset.
    """
    rng = np.random.default_rng(seed)
    n_edges = int(n_nodes * avg_degree)
    src = rng.integers(0, n_nodes, size=n_edges)
    if power_law:
        dst = (n_nodes * rng.power(0.35, size=n_edges)).astype(np.int64)
        dst = np.minimum(dst, n_nodes - 1)
        # Shuffle hub identities so hot rows are spread over the id space.
        perm = rng.permutation(n_nodes)
        dst = perm[dst]
    else:
        dst = rng.integers(0, n_nodes, size=n_edges)
    if symmetric:
        src, dst = (np.concatenate([src, dst]),
                    np.concatenate([dst, src]))
    g = CSRGraph.from_coo(src, dst.astype(np.int32), n_nodes)
    if self_loops:
        g = g.add_self_loops()
    return g
