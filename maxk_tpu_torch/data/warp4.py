"""warp4 scheduling metadata: wire-compatible generator, reader and check.

The port's copy of the JAX package's warp4 module (same functions, same
constants, bit-identical output). The reference's offline metadata
generator (reference kernels/generate_meta.py:8-48) walks CSR rows and
emits one ``(row, loc, len, 0)`` int32 quadruple per CUDA warp, each warp
owning at most ``warp_max_nz`` consecutive nonzeros of a single row;
zero-degree rows are skipped. Files live at
``w12_nz64_warp_4/<graph>.warp4``.

K2's segment plan (``ops/graph.py::SegmentPlan``) is built from
``generate_warp4`` at its own segment length.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:     # ops/graph.py imports this module
    from maxk_tpu_torch.ops.graph import CSRGraph

NUM_WARPS = 12        # reference kernels/generate_meta.py:8 (block width)
WARP_MAX_NZ = 64      # reference kernels/generate_meta.py:9
META_DIRNAME = f"w{NUM_WARPS}_nz{WARP_MAX_NZ}_warp_4"


def generate_warp4(csr: "CSRGraph",
                   warp_max_nz: int = WARP_MAX_NZ) -> np.ndarray:
    """(N_warps, 4) int32 quadruples, bit-identical to the reference
    generator's output (generate_meta.py:28-48)."""
    deg = np.diff(csr.indptr).astype(np.int64)
    nz = deg[deg > 0]
    rows = np.nonzero(deg > 0)[0]
    warps_per_row = -(-nz // warp_max_nz)
    n_warps = int(warps_per_row.sum())
    if n_warps == 0:    # all rows empty: np.repeat below would mismatch
        return np.zeros((0, 4), dtype=np.int32)

    warp_row = np.repeat(rows, warps_per_row).astype(np.int32)
    # Offset of each warp within its row: 0, warp_max_nz, 2 warp_max_nz, ...
    starts = np.concatenate([[0], np.cumsum(warps_per_row)[:-1]])
    intra = (np.arange(n_warps) - np.repeat(starts, warps_per_row)) \
        * warp_max_nz
    row_loc = np.repeat(csr.indptr[rows].astype(np.int64), warps_per_row)
    warp_loc = (row_loc + intra).astype(np.int32)
    warp_len = np.minimum(
        np.repeat(nz, warps_per_row) - intra, warp_max_nz).astype(np.int32)

    out = np.zeros((n_warps, 4), dtype=np.int32)
    out[:, 0] = warp_row
    out[:, 1] = warp_loc
    out[:, 2] = warp_len
    return out


def save_warp4(warp4: np.ndarray, base_dir: str | os.PathLike,
               name: str) -> Path:
    """Write ``<base_dir>/w12_nz64_warp_4/<name>.warp4`` (flat int32)."""
    d = Path(base_dir) / META_DIRNAME
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{name}.warp4"
    np.ascontiguousarray(warp4, dtype=np.int32).tofile(path)
    return path


def load_warp4(path: str | os.PathLike) -> np.ndarray:
    """Read a .warp4 file -> (N_warps, 4) int32."""
    flat = np.fromfile(path, dtype=np.int32)
    if flat.size % 4:
        raise ValueError(f"{path}: size {flat.size} not a multiple of 4")
    return flat.reshape(-1, 4)


def validate_warp4(warp4: np.ndarray, csr: "CSRGraph") -> None:
    """Check quadruples cover every nonzero of the graph exactly once."""
    row, loc, length = warp4[:, 0], warp4[:, 1], warp4[:, 2]
    if (length < 1).any() or (length > WARP_MAX_NZ).any():
        raise ValueError("warp len out of range")
    covered = int(length.sum())
    if covered != csr.n_edges:
        raise ValueError(
            f"warp4 covers {covered} nz, graph has {csr.n_edges}")
    starts = csr.indptr[row.astype(np.int64)]
    ends = csr.indptr[row.astype(np.int64) + 1]
    if (loc < starts).any() or (loc + length > ends).any():
        raise ValueError("warp span outside its row")
