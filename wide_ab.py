#!/usr/bin/env python
"""Time the wide top-k kernel (csrc/topk_wide.cu, both entries) built from
this checkout against the same file of another checkout, on one CUDA card,
in turns; and count the SASS of both builds' descent loops.

  python3 wide_ab.py OTHER_CHECKOUT [--out build/wide_ab]

OTHER_CHECKOUT is the root of another tree of this repository, for
example a parent commit unpacked with `git archive` into a directory
that .gitignore lists; only its maxk_tpu_torch/csrc/topk_wide.cu is
read. Both sources are built with the port's nvcc flags (k1_ab.build)
and their entries called through ctypes with the parameters each
declares: (x, a, b, n_rows, d, k, stream), or, where the entry takes a
plan, also the 16-byte path and the shared-memory bytes of this tree's
ops/cuda_topk.py::wide_plan. (To time another block size, point
OTHER_CHECKOUT at a copy of this tree with kThreads changed in
topk_wide.cu.) The inputs are float32 at k = 32: (a) randn and (b) integer ties
in [-3, 3], at (16384, 2048) and at (16384, 8192). On each input both
builds' two entries must give the same bits as the plain versions; then
each entry of each build is timed with bench/timing.py's time_fn (a
sample of 20 calls) twice over in the order other, this, this, other.
One JSON line per input and entry, then one with both builds' ptxas
registers and spills and the
instruction count of the descent loop (the loop that holds the warp sum,
REDUX; k1_ab.loop_holding) of each entry's kernel for rows in shared
memory and 16-byte aligned (the other tree's own kernel where it has one
per entry), read from `cuobjdump -sass`; the SASS listings go to OUT.
The card's name and power limit come first.
"""

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from maxk_tpu_torch.bench.kernel_table import (check, descent_steps, emit,
                                               ptxas_summary)
from maxk_tpu_torch.bench.timing import time_fn
from k1_ab import build, loop_holding

SHAPES = ((16384, 2048), (16384, 8192))
K = 32
ENTRIES = {"maxk_wide": "maxk_wide_f32",
           "cbsr_topk_wide": "cbsr_topk_wide_f32"}
# Each entry's kernel in SASS: this tree's for rows in shared memory and
# 16-byte aligned (template <kCompact, kShared = true, kVec = 4>), or an
# earlier tree's one kernel per entry.
SASS_NAMES = {"maxk_wide": ("topk_wide_kernelILb0ELb1ELi4E",
                            "maxk_wide_kernel"),
              "cbsr_topk_wide": ("topk_wide_kernelILb1ELb1ELi4E",
                                 "cbsr_topk_wide_kernel")}


def takes_plan(src: Path) -> bool:
    """Whether the source's entries take a plan (16-byte path, shared
    bytes)."""
    m = re.search(r'extern "C" int maxk_wide_f32\(([^)]*)\)',
                  src.read_text())
    check(m is not None, f"{src}: no maxk_wide_f32 entry")
    return "smem_bytes" in m.group(1)


def launchers(lib: Path, with_plan: bool):
    """{entry: f(x, k)} through the library's two entries, passing
    wide_plan's 16-byte path and bytes where `with_plan`."""
    from maxk_tpu_torch.ops.cuda_topk import wide_plan
    dll = ctypes.CDLL(str(lib))
    n_plan = 2 if with_plan else 0

    def make(name, entry):
        fn = getattr(dll, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       *[ctypes.c_int] * n_plan, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(x, k):
            v, d = x.shape
            if name == "maxk_wide":
                a = torch.empty_like(x)
                b = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
            else:
                a = torch.empty((v, k), dtype=torch.float32, device=x.device)
                b = torch.empty((v, k), dtype=torch.int32, device=x.device)
            # Fresh outputs and the inputs here are 16-byte aligned.
            plan = ((int(wide_plan(d).aligned), wide_plan(d).smem_bytes)
                    if with_plan else ())
            err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), v, d, k,
                     *plan, torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{lib.name} {entry}: CUDA error {err}")
            return a, b
        return run
    return {name: make(name, entry) for name, entry in ENTRIES.items()}


def descent_loops(lib: Path, out: Path, tag: str) -> dict:
    """Each entry's descent loop in SASS; writes the kernels' listings and
    the loops' bodies under `out`."""
    from maxk_tpu_torch.native.build import nvcc_path
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    funcs = sass.split("Function : ")[1:]
    loops = {}
    for name, patterns in SASS_NAMES.items():
        found = [f for f in funcs
                 if any(p in f.splitlines()[0] for p in patterns)]
        check(len(found) == 1, f"{lib.name}: no single {name} kernel in SASS")
        (out / f"{name}_{tag}.sass").write_text(found[0])
        loop = loop_holding(found[0], "REDUX")
        check(loop is not None, f"{lib.name}: no {name} descent loop in SASS")
        (out / f"{name}_descent_loop_{tag}.txt").write_text(
            "\n".join(loop.pop("body")) + "\n")
        loops[name] = loop
    return loops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path, default=Path("build/wide_ab"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0))

    from maxk_tpu_torch.native.build import BUILD_DIR, CSRC
    from maxk_tpu_torch.ops.cuda_topk import (cbsr_topk_plain,
                                              maxk_forward_plain)

    args.out.mkdir(parents=True, exist_ok=True)
    srcs = {"other": args.other / "maxk_tpu_torch/csrc/topk_wide.cu",
            "this": CSRC / "topk_wide.cu"}
    libs = {n: BUILD_DIR / "ab" / f"topk_wide_{n}.so" for n in srcs}
    with_plan = {n: takes_plan(src) for n, src in srcs.items()}
    ptxas = {n: build(srcs[n], libs[n]) for n in srcs}
    run = {n: launchers(libs[n], with_plan[n]) for n in srcs}
    plain = {"maxk_wide": maxk_forward_plain,
             "cbsr_topk_wide": cbsr_topk_plain}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for v, d in SHAPES:
        for name in ("a_randn", "b_ties"):
            x = (torch.randn(v, d, device=dev, generator=gen)
                 if name == "a_randn" else
                 torch.randint(-3, 4, (v, d), device=dev,
                               generator=gen).float())
            steps = descent_steps(x, K).double()
            for entry in ENTRIES:
                ref_a, ref_b = plain[entry](x, K)
                for n in srcs:
                    a, b = run[n][entry](x, K)
                    check(torch.equal(a.view(torch.int32),
                                      ref_a.view(torch.int32))
                          and torch.equal(b, ref_b),
                          f"{n} build's {entry} differs from the plain "
                          f"version on {name} {(v, d)}")
                del ref_a, ref_b, a, b
                ms = {"other": [], "this": []}
                for _ in range(2):
                    for n in ("other", "this", "this", "other"):
                        ms[n].append(time_fn(
                            lambda: run[n][entry](x, K), 3, 1).mean_ms)
                emit("wide_ab", entry=entry, input=name, shape=[v, d], k=K,
                     mean_steps=float(steps.mean()),
                     rows_all_32_steps=float((steps == 32).double().mean()),
                     other_ms=ms["other"], this_ms=ms["this"],
                     other_mean_ms=statistics.mean(ms["other"]),
                     this_mean_ms=statistics.mean(ms["this"]),
                     this_over_other=statistics.mean(ms["this"])
                     / statistics.mean(ms["other"]))
            del x

    emit("wide_sass", other=str(srcs["other"]), this=str(srcs["this"]),
         takes_plan=with_plan,
         ptxas={n: ptxas_summary(r) for n, r in ptxas.items()},
         descent_loop={n: descent_loops(libs[n], args.out, n)
                       for n in srcs})
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
