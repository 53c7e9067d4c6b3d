"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
       -Xcompiler -fPIC -Xptxas -v -o build/maxk_tpu_torch/<name>-<hash>.so

The library lands in ``build/maxk_tpu_torch/`` of the checkout, keyed by
a hash of its source, the shared headers (``csrc/*.cuh``) and the flags,
so a changed source rebuilds and an unchanged one loads at once. ``ptxas``'s register and spill report is
kept beside it as ``<name>-<hash>.ptxas.txt``. ``build_all`` starts every
build together; a wrapper's first launch loads (and if needed builds)
only its own library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "maxk_tpu_torch"
# Every source in csrc/: the kernels, and the roofline's gather probe.
KERNELS = ("maxk_topk", "cbsr_topk", "spmm_csr", "cbsr_gather",
           "topk_wide", "spgemm_cbsr", "cbsr_expand", "spmm_int8",
           "gather_probe")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC, or put "
                       "nvcc on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one kernel into a temporary file; None if the
    library is already built."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), lib


def _finish_build(name: str, job) -> str:
    """Wait for nvcc, move the library into place, return ptxas' report."""
    proc, tmp, lib = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    # The rename is atomic, so a concurrent process never loads half a file.
    lib.with_suffix(".ptxas.txt").write_text(out)
    tmp.replace(lib)
    return out


def build_all() -> dict:
    """Build every kernel library, all nvcc processes at once.

    Returns {name: {"seconds": wall time of this build (0.0 if it was
    already built), "ptxas": ptxas' -v report}}.
    """
    t0 = time.perf_counter()
    jobs = {name: _start_build(name) for name in KERNELS}
    result = {}
    for name, job in jobs.items():
        if job is not None:
            _finish_build(name, job)
        report = _lib_path(name).with_suffix(".ptxas.txt")
        result[name] = {
            "seconds": (time.perf_counter() - t0) if job else 0.0,
            "ptxas": report.read_text() if report.exists() else ""}
    return result


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    job = _start_build(name)
    if job is not None:
        _finish_build(name, job)
    return ctypes.CDLL(str(_lib_path(name)))
