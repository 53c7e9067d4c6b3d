#!/usr/bin/env python
"""Time K4 built from this checkout against K4 built from another
checkout's source, on one CUDA card, in turns; and count the SASS of
both descent loops and of what follows them.

  python3 k4_ab.py OTHER_CHECKOUT [--out build/k4_ab]

OTHER_CHECKOUT is the root of another tree of this repository, for
example a parent commit unpacked with `git archive` into a directory
that .gitignore lists; only its maxk_tpu_torch/csrc/cbsr_topk.cu is
read. Both sources are built with the port's nvcc flags (k1_ab.build)
and launched through the same ctypes call. The inputs are all
(131072, 256) float32 at k = 32: (a) randn, (b) integer ties in [-3, 3],
(c) the x each of the 4 hidden layers hands K4 in the first step of
chip_smoke.py's training on the CBSR route (MAXK_FUSED_MASK=0). On each
input the two builds must give the same bits as the plain version; then
each is timed with chip_smoke.time_ms twice over in the order other,
this, this, other. One JSON line per input, then one with both builds'
ptxas registers and spills (all six VPL instantiations) and, in the
VPL = 8 instantiation, the instruction count of the descent loop's body
(the loop that holds the warp sum, REDUX; k1_ab.loop_holding) and of
everything after that loop (the count of key > t and the compaction),
read from `cuobjdump -sass`; the SASS listings go to OUT. The card's
name and power limit come first.
"""

import argparse
import collections
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from chip_smoke import check, descent_steps, emit, time_ms
from k1_ab import build, loop_holding

V, D, K = 131072, 256, 32


def launcher(lib: Path):
    """f(x, k) -> (values, selector) through the library's cbsr_topk_f32."""
    fn = ctypes.CDLL(str(lib)).cbsr_topk_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, k):
        values = torch.empty((x.shape[0], k), dtype=torch.float32,
                             device=x.device)
        selector = torch.empty((x.shape[0], k), dtype=torch.int32,
                               device=x.device)
        err = fn(x.data_ptr(), values.data_ptr(), selector.data_ptr(),
                 x.shape[0], x.shape[1], k,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"{lib.name}: CUDA error {err}")
        return values, selector
    return run


def sass_counts(lib: Path, listing: Path) -> dict:
    """The VPL = 8 kernel's descent loop and the instructions after it,
    in SASS. Writes the kernel's listing to `listing`."""
    from maxk_tpu_torch.native.build import nvcc_path
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if "cbsr_topk_kernelILi8E" in f.splitlines()[0]]
    check(len(funcs) == 1, f"{lib.name}: no single VPL = 8 kernel in SASS")
    listing.write_text(funcs[0])
    loop = loop_holding(funcs[0], "REDUX")
    check(loop is not None, f"{lib.name}: no descent loop found in SASS")
    instrs = [i.strip() for i in
              re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]+);", funcs[0])]
    body = loop["body"]
    end = next(i + len(body) for i in range(len(instrs))
               if instrs[i:i + len(body)] == body)
    # The tail up to EXIT; the padding after it (BRA to itself, NOPs) is
    # not code.
    tail = instrs[end:]
    tail = tail[:max(i for i, t in enumerate(tail) if "EXIT" in t) + 1]
    ops = collections.Counter(
        re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0]
        for i in tail)
    return {"descent_loop": loop,
            "after_loop": {"instructions": len(tail), "by_opcode": dict(ops),
                           "body": tail}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path, default=Path("build/k4_ab"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0))

    from maxk_tpu_torch.data.loaders import synthetic_graph
    from maxk_tpu_torch.models.models import GraphBundle
    from maxk_tpu_torch.native.build import BUILD_DIR, CSRC
    from maxk_tpu_torch.ops.cuda_topk import cbsr_topk_plain

    args.out.mkdir(parents=True, exist_ok=True)
    libs = {"other": BUILD_DIR / "ab" / "cbsr_topk_other.so",
            "this": BUILD_DIR / "ab" / "cbsr_topk_this.so"}
    srcs = {"other": args.other / "maxk_tpu_torch/csrc/cbsr_topk.cu",
            "this": CSRC / "cbsr_topk.cu"}
    ptxas = {n: build(srcs[n], libs[n]) for n in libs}
    run = {n: launcher(lib) for n, lib in libs.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = [("a_randn", torch.randn(V, D, device=dev, generator=gen)),
              ("b_ties", torch.randint(-3, 4, (V, D), device=dev,
                                       generator=gen).float())]
    csr = synthetic_graph(V, 50.0, seed=123)
    bundle = GraphBundle.from_csr(csr, norms=("mean",), symmetric=True,
                                  device=dev)
    with chip_smoke.cbsr_env():
        layers = chip_smoke.k1_train_inputs(
            chip_smoke.train_config(4), chip_smoke.bench_dataset(csr, V, D),
            bundle)
    inputs += [(f"c_layer{i}", x) for i, x in enumerate(layers)]

    for name, x in inputs:
        v_ref, s_ref = cbsr_topk_plain(x, K)
        for n, f in run.items():
            values, selector = f(x, K)
            check(torch.equal(values.view(torch.int32),
                              v_ref.view(torch.int32))
                  and torch.equal(selector, s_ref),
                  f"{n} build differs from the plain version on {name}")
        ms = {"other": [], "this": []}
        for _ in range(2):
            for n in ("other", "this", "this", "other"):
                ms[n].append(time_ms(lambda: run[n](x, K)))
        steps = descent_steps(x, K).double()
        emit("k4_ab", input=name, shape=[V, D], k=K,
             mean_steps=float(steps.mean()),
             rows_all_32_steps=float((steps == 32).double().mean()),
             other_ms=ms["other"], this_ms=ms["this"],
             other_mean_ms=statistics.mean(ms["other"]),
             this_mean_ms=statistics.mean(ms["this"]),
             this_over_other=statistics.mean(ms["this"])
             / statistics.mean(ms["other"]))

    sass = {}
    for n, lib in libs.items():
        counts = sass_counts(lib, args.out / f"cbsr_topk_vpl8_{n}.sass")
        for part, c in counts.items():
            (args.out / f"{part}_{n}.txt").write_text(
                "\n".join(c.pop("body")) + "\n")
        sass[n] = counts
    emit("k4_sass", other=str(srcs["other"]), this=str(srcs["this"]),
         ptxas={n: chip_smoke.ptxas_summary(r) for n, r in ptxas.items()},
         vpl8=sass)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
