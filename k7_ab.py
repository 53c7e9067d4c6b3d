#!/usr/bin/env python
"""Time K7 (the int8 SpMM) and K6 (cbsr_expand, its int8 mode above all)
built from this checkout against the same kernels built from other
checkouts' source, on one CUDA card, in turns.

  python3 k7_ab.py OTHER [OTHER ...] [--reddit] [--out build/k7_ab]
                   [--unchecked OTHER ...]

Each OTHER is the root of another tree of this repository, for example
the parent commit unpacked with `git archive HEAD maxk_tpu_torch/csrc`
into build/parent, which .gitignore lists; only its
maxk_tpu_torch/csrc/spmm_int8.cu and cbsr_expand.cu (with the headers
beside them) are read. A variant is a copy of this tree's csrc with one
constant changed (sed), e.g. K7's edges in flight a lane. Every build
uses the port's nvcc flags (k1_ab.build) and is called through the same
C interface.

The inputs are chip_smoke.py's cell: the mean-normalised
synthetic_graph(131072, 50.0, seed=123), E = 13,107,200, D = 256, x a
randn (131072, 256); K7's column-scale table is quantize_columns(x), its
row-scale table K6's int8 mode on the k = 32 CBSR rows of x. With
--reddit, K7 also runs on train_bench's reddit graph (V = 232,965, E =
114,618,780; ~35 s of graph build on the host). First every build must
give the same bits: K7 in both scale modes at both slabs (and slab 128
the same as slab 256; not the --unchecked builds, stripped variants that
time a part), K6's int8 q and scale (also equal to the plain
version), K6's float32 and bfloat16 outputs. Then each OTHER is timed
against this build with chip_smoke.time_ms twice over in the order other,
this, this, other: K7 per mode and slab, K6's int8 mode and its float32
and bfloat16 outputs (float32 values, k = 32). One JSON line per shape
with the SM clock nvidia-smi reported while it ran and K7's values a
clock an SM (E * D over the time, 132 SMs, the median clock); then one
with every build's ptxas registers and spills and, per instantiation of
spmm_int8_segment_kernel, its int-to-float conversions (I2F*, I2FP*) and
its count of a few opcodes (OPCODES) in SASS (`cuobjdump -sass`,
listings in OUT).
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

import chip_smoke
from chip_smoke import check, emit, time_ms
from k1_ab import build

V, D, K, AVG_DEGREE, GRAPH_SEED = 131072, 256, 32, 50.0, 123
SMS = 132


def launchers(k7_lib: Path, k6_lib: Path):
    """(k7(g, q, scale, row, slab) -> out, k6_int8(values, sel) -> (q,
    scale), k6(values, sel, out_dtype) -> out) through the libraries'
    entries."""
    k7 = ctypes.CDLL(str(k7_lib)).spmm_int8
    k7.argtypes = ([ctypes.c_void_p] * 10
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int64]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    k7.restype = ctypes.c_int
    so6 = ctypes.CDLL(str(k6_lib))
    k6i, k6f = so6.cbsr_expand_int8, so6.cbsr_expand
    k6i.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]
    k6f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]
    k6i.restype = k6f.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run_k7(g, q, scale, row, slab):
        plan, d = g.plan, q.shape[1]
        out = torch.empty((g.n_nodes, d), dtype=torch.float32,
                          device=q.device)
        partials = torch.empty((plan.n_partials, d), dtype=torch.float32,
                               device=q.device)
        err = k7(g.indptr.data_ptr(), g.indices.data_ptr(),
                 g.values.data_ptr(), q.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), partials.data_ptr(), plan.seg_row.data_ptr(),
                 plan.seg_start.data_ptr(), plan.seg_slot.data_ptr(),
                 plan.n_segments, plan.seg_len, plan.fin_row.data_ptr(),
                 plan.fin_ptr.data_ptr(), plan.fin_row.shape[0], d,
                 int(row), slab, stream())
        check(err == 0, f"{k7_lib.name}: CUDA error {err}")
        return out

    def run_k6_int8(values, sel):
        (v, k), dev = values.shape, values.device
        q = torch.empty((v, D), dtype=torch.int8, device=dev)
        scale = torch.empty((v,), dtype=torch.float32, device=dev)
        err = k6i(values.data_ptr(), int(values.dtype == torch.bfloat16),
                  sel.data_ptr(), int(sel.dtype == torch.uint8),
                  q.data_ptr(), scale.data_ptr(), v, k, D,
                  int(q.data_ptr() % 16 == 0), stream())
        check(err == 0, f"{k6_lib.name}: CUDA error {err}")
        return q, scale

    def run_k6(values, sel, out_dtype):
        (v, k), dev = values.shape, values.device
        out = torch.empty((v, D), dtype=out_dtype, device=dev)
        err = k6f(values.data_ptr(), int(values.dtype == torch.bfloat16),
                  sel.data_ptr(), int(sel.dtype == torch.uint8),
                  out.data_ptr(), int(out_dtype == torch.bfloat16), v, k, D,
                  int(out.data_ptr() % 16 == 0), stream())
        check(err == 0, f"{k6_lib.name}: CUDA error {err}")
        return out
    return run_k7, run_k6_int8, run_k6


# Opcodes counted in K7's segment kernels: the conversion, the byte
# permute and the logic op that can stand in for it, the adds and FMAs.
OPCODES = ("I2F", "I2FP", "PRMT", "LOP3", "SHF", "FADD", "FFMA", "SHFL",
           "LDG")


def sass_counts(lib: Path, listing: Path) -> dict:
    """Per instantiation of spmm_int8_segment_kernel: its I2F* and I2FP*
    instructions and the count of each of OPCODES; the SASS listings go
    to `listing`."""
    funcs = chip_smoke.sass_functions(str(lib), "spmm_int8_segment_kernel")
    check(len(funcs) == 4, f"{lib.name}: {len(funcs)} instantiations of "
                           f"spmm_int8_segment_kernel in SASS, not 4")
    listing.write_text("".join(funcs.values()))
    out = {}
    for name, f in funcs.items():
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                         f)
        out[name] = {"int_to_float": chip_smoke.count_int_to_float(f),
                     **{op: ops.count(op) for op in OPCODES}}
    return out


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def k7_round(name, g, tables, run, others, unchecked=()) -> dict:
    """K7's bits checked across builds (but `unchecked`) and slabs, then
    timed in turns."""
    e, d = g.n_edges, D
    for mode, (q, sc, row) in tables.items():
        ref = run["this"][0](g, q, sc, row, 256)
        for n, (k7, _, _) in run.items():
            if n in unchecked:
                continue
            for slab in (128, 256):
                check(torch.equal(bits(k7(g, q, sc, row, slab)), bits(ref)),
                      f"{name}: K7 of {n} at slab {slab} ({mode} scale) "
                      f"differs from this build's at slab 256")
        del ref
    ms = {f"{mode}_slab{slab}": {n: [] for n in run}
          for mode in tables for slab in (128, 256)}
    with chip_smoke.sm_clock() as mhz:
        for mode, (q, sc, row) in tables.items():
            for slab in (128, 256):
                cell = ms[f"{mode}_slab{slab}"]
                for other in others:
                    for _ in range(2):
                        for n in (other, "this", "this", other):
                            cell[n].append(time_ms(
                                lambda: run[n][0](g, q, sc, row, slab)))
    clock = statistics.median(mhz)
    mean = {c: {n: statistics.mean(t) for n, t in by.items()}
            for c, by in ms.items()}
    return dict(
        shape=name, V=g.n_nodes, E=e, D=d, ms=ms, mean_ms=mean,
        over_this={c: {n: t / by["this"] for n, t in by.items()}
                   for c, by in mean.items()},
        values_per_clock_per_sm={
            c: {n: e * d / (t * 1e-3) / (SMS * clock * 1e6)
                for n, t in by.items()} for c, by in mean.items()},
        sm_clock_mhz=dict(median=clock, min=min(mhz), max=max(mhz),
                          samples=len(mhz)))


def k6_round(values, selector, run, others) -> dict:
    """K6's bits checked across builds (int8 also against the plain
    version), then its int8 mode and float32 and bfloat16 outputs timed
    in turns."""
    from maxk_tpu_torch.ops.cuda_expand import cbsr_expand_int8_plain
    q_ref, s_ref = cbsr_expand_int8_plain(values, selector, D)
    outs = {dt: run["this"][2](values, selector, dt)
            for dt in (torch.float32, torch.bfloat16)}
    for n, (_, k6i, k6) in run.items():
        q, s = k6i(values, selector)
        check(torch.equal(q, q_ref) and torch.equal(bits(s), bits(s_ref)),
              f"K6's int8 mode of {n} differs from the plain version")
        for dt, ref in outs.items():
            check(torch.equal(bits(k6(values, selector, dt)), bits(ref)),
                  f"K6 of {n} into {dt} differs from this build's")
    del q_ref, s_ref, outs
    fns = {"int8": lambda r: r[1](values, selector),
           "float32": lambda r: r[2](values, selector, torch.float32),
           "bfloat16": lambda r: r[2](values, selector, torch.bfloat16)}
    ms = {c: {n: [] for n in run} for c in fns}
    for c, fn in fns.items():
        for other in others:
            for _ in range(2):
                for n in (other, "this", "this", other):
                    ms[c][n].append(time_ms(lambda: fn(run[n])))
    mean = {c: {n: statistics.mean(t) for n, t in by.items()}
            for c, by in ms.items()}
    return dict(V=values.shape[0], k=values.shape[1], D=D,
                values=str(values.dtype), selectors=str(selector.dtype),
                ms=ms, mean_ms=mean,
                over_this={c: {n: t / by["this"] for n, t in by.items()}
                           for c, by in mean.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+")
    ap.add_argument("--reddit", action="store_true",
                    help="also K7 on train_bench's reddit graph")
    ap.add_argument("--out", default="build/k7_ab")
    ap.add_argument("--unchecked", nargs="*", default=[],
                    help="OTHERs whose K7 is timed but not held to this "
                         "build's bits (stripped variants that time a part)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0))

    from maxk_tpu_torch.data.loaders import synthetic_graph
    from maxk_tpu_torch.native.build import BUILD_DIR, CSRC
    from maxk_tpu_torch.ops.cbsr import cbsr_expand_int8, cbsr_topk
    from maxk_tpu_torch.ops.graph import DeviceCSR
    from maxk_tpu_torch.ops.spmm import quantize_columns

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"this": CSRC, **{o: Path(o) / "maxk_tpu_torch/csrc"
                              for o in args.others}}
    ptxas, i2f, run = {}, {}, {}
    for i, (n, csrc) in enumerate(trees.items()):
        libs = [BUILD_DIR / "k7_ab" / f"{src}_{i}.so"
                for src in ("spmm_int8", "cbsr_expand")]
        ptxas[n] = {src: chip_smoke.ptxas_summary(
            build(csrc / f"{src}.cu", lib))
            for src, lib in zip(("spmm_int8", "cbsr_expand"), libs)}
        i2f[n] = sass_counts(libs[0], out_dir / f"spmm_int8_{i}.sass")
        run[n] = launchers(*libs)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def tables(g):
        x = torch.randn(g.n_nodes, D, device=dev, generator=gen)
        values, selector = cbsr_topk(x, K)
        return x, values, selector, {
            "column": (*quantize_columns(x), False),
            "row": (*cbsr_expand_int8(values, selector, D), True)}

    g = DeviceCSR.from_csr(
        synthetic_graph(V, AVG_DEGREE, seed=GRAPH_SEED).normalize("mean"),
        dev)
    x, values, selector, tabs = tables(g)
    emit("k7_ab", **k7_round("cell", g, tabs, run, args.others,
                             args.unchecked))
    for sel in (selector, selector.to(torch.uint8)):
        emit("k6_ab", **k6_round(values, sel, run, args.others))
    del g, x, values, selector, tabs
    if args.reddit:
        from maxk_tpu_torch.bench.train_bench import reddit_dataset
        g = DeviceCSR.from_csr(reddit_dataset().csr.normalize("mean"), dev)
        x, values, selector, tabs = tables(g)
        del x, values, selector
        emit("k7_ab", **k7_round("reddit", g, tabs, run, args.others,
                                 args.unchecked))
        del g, tabs

    emit("k7_builds", sources={n: str(c) for n, c in trees.items()},
         ptxas=ptxas, k7_sass=i2f)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
