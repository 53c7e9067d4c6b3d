#!/usr/bin/env python
"""Time K5 built from this checkout against K5 built from other
checkouts' source, on one CUDA card, in turns.

  python3 k5_ab.py OTHER[:NAME,...] [OTHER[:NAME,...] ...]
                   [--ks 16 32 64] [--dtypes bfloat16 float32]
                   [--unchecked]

Each OTHER is the root of another tree of this repository, for example
a parent commit unpacked with `git archive HEAD maxk_tpu_torch/csrc`
into a directory that .gitignore lists; only its
maxk_tpu_torch/csrc/spgemm_cbsr.cu (with the headers beside it) is
read. NAMEs after a colon are defined for that build (-DNAME), so one
tree can give several variants. Every build uses the port's nvcc flags
(k1_ab.build) and is called through its own C interface: this one's
(records and a work list) or the earlier one (the segment plan's
arrays), told apart by the library's exports.

The inputs are the cell of chip_smoke.py's phase 19: the mean-normalised
synthetic_graph(131072, 50.0, seed=123), D = 256, and the CBSR table of
a randn (131072, 256) at each k, with bfloat16 or float32 values and
uint8 selectors. At each k and dtype every build must give the same
bits as the plain version (--unchecked: only this build is checked, the
others are stripped variants that time a part); then each OTHER is
timed against this build with chip_smoke.time_ms twice over in the order
other, this, this, other. One JSON line per k and dtype, with the SM
clock nvidia-smi reported while it ran and this kernel's wavefront
model at that clock (chip_smoke.k5_wavefronts); then one with every
build's ptxas registers and spills. The card's name and power limit
come first.
"""

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from chip_smoke import check, emit, time_ms
from k1_ab import build

V, D, AVG_DEGREE, GRAPH_SEED = 131072, 256, 50.0, 123
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def launcher(lib: Path):
    """f(g, values, sel8) -> out through the library's K5 entry."""
    so = ctypes.CDLL(str(lib))
    new = hasattr(so, "spgemm_cbsr_pack_bf16")
    fns = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        fn = getattr(so, f"spgemm_cbsr_{name}")
        if new:
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                           + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                           + [ctypes.c_void_p] * 4
                           + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 10
                           + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int64]
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[dtype] = fn

    def run(g, values, sel8):
        plan, dev, (n, k) = g.plan, values.device, values.shape
        out = torch.empty((g.n_nodes, D), dtype=torch.float32, device=dev)
        partials = torch.empty((plan.n_partials, D), dtype=torch.float32,
                               device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if new:
            # Room for 4-byte records a kept entry, 8 with float32 values
            # (as this PR's first build wrote them).
            records = torch.empty(n * k * values.element_size() * 2,
                                  dtype=torch.uint8, device=dev)
            err = fns[values.dtype](
                g.indices.data_ptr(), g.values.data_ptr(),
                values.data_ptr(), sel8.data_ptr(), n, records.data_ptr(),
                plan.work.data_ptr(), plan.n_segments, out.data_ptr(),
                partials.data_ptr(), plan.fin_row.data_ptr(),
                plan.fin_ptr.data_ptr(), plan.fin_row.shape[0], k, D,
                stream)
        else:
            err = fns[values.dtype](
                g.indptr.data_ptr(), g.indices.data_ptr(),
                g.values.data_ptr(), values.data_ptr(), sel8.data_ptr(),
                out.data_ptr(), partials.data_ptr(), plan.seg_row.data_ptr(),
                plan.seg_start.data_ptr(), plan.seg_slot.data_ptr(),
                plan.n_segments, plan.seg_len, plan.fin_row.data_ptr(),
                plan.fin_ptr.data_ptr(), plan.fin_row.shape[0], k, D,
                stream)
        check(err == 0, f"{lib.name}: CUDA error {err}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+")
    ap.add_argument("--ks", type=int, nargs="+", default=[16, 32, 64])
    ap.add_argument("--dtypes", nargs="+", choices=sorted(DTYPES),
                    default=["bfloat16", "float32"])
    ap.add_argument("--unchecked", action="store_true",
                    help="hold only this build to the plain version")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0))

    from maxk_tpu_torch.data.loaders import synthetic_graph
    from maxk_tpu_torch.native.build import BUILD_DIR, CSRC
    from maxk_tpu_torch.ops.cuda_spgemm_cbsr import spgemm_cbsr_plain
    from maxk_tpu_torch.ops.cuda_topk import cbsr_topk_forward
    from maxk_tpu_torch.ops.graph import DeviceCSR

    srcs = {"this": (CSRC / "spgemm_cbsr.cu", [])}
    for spec in args.others:
        tree, _, names = spec.partition(":")
        srcs[spec] = (Path(tree) / "maxk_tpu_torch/csrc/spgemm_cbsr.cu",
                      [f"-D{n}" for n in names.split(",") if n])
    libs = {n: BUILD_DIR / "k5_ab" / f"spgemm_cbsr_{i}.so"
            for i, n in enumerate(srcs)}
    ptxas = {n: build(src, libs[n], flags)
             for n, (src, flags) in srcs.items()}
    run = {n: launcher(lib) for n, lib in libs.items()}

    dev = torch.device("cuda")
    g = DeviceCSR.from_csr(
        synthetic_graph(V, AVG_DEGREE, seed=GRAPH_SEED).normalize("mean"),
        dev)
    x = torch.randn(V, D, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    for k in args.ks:
        values, selector = cbsr_topk_forward(x, k)
        sel8 = selector.to(torch.uint8)
        for dname in args.dtypes:
            vc = values.to(DTYPES[dname])
            plain = spgemm_cbsr_plain(g, vc, sel8, D)
            for n, f in run.items():
                if n == "this" or not args.unchecked:
                    check(torch.equal(f(g, vc, sel8), plain),
                          f"{n} differs from the plain version at k={k} "
                          f"{dname}")
            del plain
            ms = {n: [] for n in run}
            with chip_smoke.sm_clock() as mhz:
                for other in args.others:
                    for _ in range(2):
                        for n in (other, "this", "this", other):
                            ms[n].append(time_ms(lambda: run[n](g, vc,
                                                                sel8)))
            model = chip_smoke.k5_wavefronts(g, sel8, k,
                                             vc.element_size(),
                                             statistics.median(mhz))
            emit("k5_ab", k=k, values=dname, V=V, E=g.n_edges, D=D, ms=ms,
                 mean_ms={n: statistics.mean(t) for n, t in ms.items()},
                 over_this={n: statistics.mean(t)
                            / statistics.mean(ms["this"])
                            for n, t in ms.items()},
                 sm_clock_mhz=dict(median=statistics.median(mhz),
                                   min=min(mhz), max=max(mhz),
                                   samples=len(mhz)),
                 wavefront_model=model)
        del values, selector, sel8

    emit("k5_ptxas", sources={n: [str(s), f] for n, (s, f) in srcs.items()},
         ptxas={n: chip_smoke.ptxas_summary(r) for n, r in ptxas.items()})
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
