#!/usr/bin/env python
"""Time K1 built from this checkout against K1 built from another
checkout's source, on one CUDA card, in turns; and count the SASS of
both descent loops.

  python3 k1_ab.py OTHER_CHECKOUT [--out build/k1_ab]

OTHER_CHECKOUT is the root of another tree of this repository, for
example a parent commit unpacked with `git archive` into a directory
that .gitignore lists; only its maxk_tpu_torch/csrc/maxk_topk.cu is
read. Both sources are built with the port's nvcc flags
(maxk_tpu_torch/native/build.py) and launched through the same ctypes
call. The inputs are bench/kernel_table.py's cell, all (131072, 256)
float32 at k = 32: (a) randn, (b) integer ties in [-3, 3], (c) the x
each of the 4 hidden layers hands K1 in the first step of its training.
On each input the two builds must give the same bits as the plain
version; then each is timed with bench/timing.py's time_fn (a sample of
20 calls) twice over in the order other, this, this, other. One JSON
line per input, then one with both builds' ptxas registers and the
instruction count of the descent loop's body in the VPL = 8
instantiation (the loop that holds the warp sum, REDUX), read from
`cuobjdump -sass`; the SASS listings go to OUT. The card's name and
power limit come first.
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

from maxk_tpu_torch.bench.kernel_table import (D, K, V, bench_dataset,
                                               cell_csr, check,
                                               descent_steps, emit,
                                               layer_inputs, ptxas_summary,
                                               train_config)
from maxk_tpu_torch.bench.timing import time_fn


def build(src: Path, out: Path, flags=()) -> str:
    """nvcc src into the library out, with the port's flags and any
    `flags` after them; returns ptxas' -v report."""
    from maxk_tpu_torch.native.build import NVCC_FLAGS, nvcc_path
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(out),
                          str(src)], capture_output=True, text=True,
                         timeout=600)
    check(res.returncode == 0, f"nvcc failed for {src}:\n{res.stdout}"
                               f"{res.stderr}")
    return res.stdout + res.stderr


def launcher(lib: Path):
    """f(x, k) -> (y, mask) through the library's maxk_topk_f32."""
    fn = ctypes.CDLL(str(lib)).maxk_topk_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, k):
        y = torch.empty_like(x)
        mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
        err = fn(x.data_ptr(), y.data_ptr(), mask.data_ptr(), x.shape[0],
                 x.shape[1], k, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"{lib.name}: CUDA error {err}")
        return y, mask
    return run


def descent_loop(lib: Path, listing: Path) -> dict:
    """The VPL = 8 kernel's descent loop in SASS: the loop (a backward
    branch and the instructions from its target to it) that holds the
    REDUX of __reduce_add_sync. Writes the kernel's listing to
    `listing`."""
    from maxk_tpu_torch.native.build import nvcc_path
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if "maxk_topk_kernelILi8E" in f.splitlines()[0]]
    check(len(funcs) == 1, f"{lib.name}: no single VPL = 8 kernel in SASS")
    listing.write_text(funcs[0])
    loop = loop_holding(funcs[0], "REDUX")
    check(loop is not None, f"{lib.name}: no descent loop found in SASS")
    return loop


def loop_holding(func: str, opcode: str):
    """The first loop of a cuobjdump function listing whose body holds
    `opcode`: {instructions, by_opcode, body}, or None. A branch names
    its target by address (`BRA 0x680`) or by label (`.L_x_3`)."""
    instrs, at, pending = [], {}, []
    for line in func.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if m:
            for name in pending + [hex(int(m.group(1), 16))]:
                at[name] = len(instrs)
            pending = []
            instrs.append(m.group(2).strip())
    for end, text in enumerate(instrs):
        m = re.search(r"BRA[^`0]*(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", text)
        target = m and at.get(m.group(1) or hex(int(m.group(2), 16)))
        if target is not None and target <= end:
            body = instrs[target:end + 1]
            if any(opcode in i for i in body):
                ops = collections.Counter(
                    re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0]
                    for i in body)
                return {"instructions": len(body), "by_opcode": dict(ops),
                        "body": body}
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path, default=Path("build/k1_ab"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0))

    from maxk_tpu_torch.models.models import GraphBundle
    from maxk_tpu_torch.native.build import BUILD_DIR, CSRC
    from maxk_tpu_torch.ops.cuda_topk import maxk_forward_plain

    args.out.mkdir(parents=True, exist_ok=True)
    libs = {"other": BUILD_DIR / "ab" / "maxk_topk_other.so",
            "this": BUILD_DIR / "ab" / "maxk_topk_this.so"}
    srcs = {"other": args.other / "maxk_tpu_torch/csrc/maxk_topk.cu",
            "this": CSRC / "maxk_topk.cu"}
    ptxas = {n: build(srcs[n], libs[n]) for n in libs}
    run = {n: launcher(lib) for n, lib in libs.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = [("a_randn", torch.randn(V, D, device=dev, generator=gen)),
              ("b_ties", torch.randint(-3, 4, (V, D), device=dev,
                                       generator=gen).float())]
    csr = cell_csr()
    bundle = GraphBundle.from_csr(csr, norms=("mean",), symmetric=True,
                                  device=dev)
    layers = layer_inputs(train_config(), bench_dataset(csr), bundle)
    inputs += [(f"c_layer{i}", x) for i, x in enumerate(layers)]

    for name, x in inputs:
        y_ref, m_ref = maxk_forward_plain(x, K)
        for n, f in run.items():
            y, mask = f(x, K)
            check(torch.equal(y.view(torch.int32), y_ref.view(torch.int32))
                  and torch.equal(mask, m_ref),
                  f"{n} build differs from the plain version on {name}")
        ms = {"other": [], "this": []}
        for _ in range(2):
            for n in ("other", "this", "this", "other"):
                ms[n].append(time_fn(lambda: run[n](x, K), 3, 1).mean_ms)
        steps = descent_steps(x, K).double()
        emit("k1_ab", input=name, shape=[V, D], k=K,
             mean_steps=float(steps.mean()),
             rows_all_32_steps=float((steps == 32).double().mean()),
             other_ms=ms["other"], this_ms=ms["this"],
             other_mean_ms=statistics.mean(ms["other"]),
             this_mean_ms=statistics.mean(ms["this"]),
             this_over_other=statistics.mean(ms["this"])
             / statistics.mean(ms["other"]))

    loops = {}
    for n, lib in libs.items():
        loop = descent_loop(lib, args.out / f"maxk_topk_vpl8_{n}.sass")
        (args.out / f"descent_loop_{n}.txt").write_text(
            "\n".join(loop.pop("body")) + "\n")
        loops[n] = loop
    emit("k1_sass", other=str(srcs["other"]), this=str(srcs["this"]),
         ptxas={n: ptxas_summary(r) for n, r in ptxas.items()},
         descent_loop_vpl8=loops)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
