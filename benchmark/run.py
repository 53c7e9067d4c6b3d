"""Run one cell of the benchmark once.

  python -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

From the root of a checkout: builds the cell's inputs and weights from
``--seed`` on the card, builds the program's Trainer on them, in cells
that evaluate evaluates those weights once, drives it through three
epochs (set-up: they build and warm every kernel and shape, and are the
steps the reference follows), then runs epochs for
``--seconds`` (the window, which ends in ``torch.cuda.synchronize()``).
With ``--trace 1`` the window runs under ``torch.profiler`` and the
result holds the cell's per-layer metrics, else its end-to-end ones. Then
the program is freed and the plain reference evaluates the same weights
and follows the first three steps; ``correct`` is their comparison (``check.py``), and every number
compared is printed beside its limit as the last lines on stderr. The
last line on stdout is the result, one JSON object.

Exits non-zero, and prints no result, without as many CUDA cards as the
cell asks for, without the program, or if ``jax``, ``jaxlib``, ``flax``
or ``maxk_tpu`` was loaded.
"""

import time

T0 = time.perf_counter()    # set-up is timed from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark.spec import Cell, load_cell  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "maxk_tpu")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the program may not
    load, compared whole."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float = T0) -> dict:
    """One run of ``cell`` on ``device``; returns the result's dict."""
    import numpy as np
    import torch
    from torch import profiler

    from benchmark import cell as C
    from benchmark import check
    from benchmark.trace import WINDOW, traced
    from maxk_tpu_torch.ops import kernel_counters

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_in = time.perf_counter()
    inputs = C.make_inputs(cell, seed, device)
    sync()
    inputs_s = time.perf_counter() - t_in
    if cuda:
        # The peak is the program's: the inputs' drawing is not counted.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    prog = C.Program(cell, inputs, seed, device)
    mine = prog.first_steps(inputs)
    sync()
    setup_s = time.perf_counter() - t0
    log(f"# {cell.name} seed {seed}: V={cell.config['graph']['n_nodes']} "
        f"E={inputs.indices.shape[0]} inputs {inputs_s:.3f}s trainer "
        f"{prog.build_s:.3f}s set-up {setup_s:.3f}s")

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    span = profiler.record_function if trace else contextlib.nullcontext
    losses = []
    with (traced(cuda) if trace else contextlib.nullcontext([])) as got:
        with span(WINDOW):
            w0 = time.perf_counter()
            while True:
                losses.append(prog.epoch(span))
                if time.perf_counter() - w0 >= seconds:
                    break
            sync()
            window_s = time.perf_counter() - w0
    epochs = len(losses)
    log(f"# window {window_s:.3f}s, {epochs} epochs; after it "
        f"{time.perf_counter() - w0 - window_s:.3f}s to read the trace")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    log("# launches an epoch: " + json.dumps(
        {k: fn.launches / epochs for k, fn in counters.items()
         if fn.launches}))

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name() if cuda
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": peak}
    if cuda:
        device_info["power_limit"] = power_limit()
    result = {"correct": None, "attempted": epochs, "failed": failed}
    if trace:
        tr = got[0]
        info = C.RunInfo(cell=cell, trace=tr, epochs=epochs,
                         trainer_build_s=prog.build_s,
                         n_nodes=cell.config["graph"]["n_nodes"],
                         n_edges=int(inputs.indices.shape[0]),
                         degrees=torch.from_numpy(np.diff(inputs.indptr)))
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy_us, _ = tr.busy_and_gaps()
        device_info.update(busy_s=busy_us / 1e6,
                           window_s=(tr.window[1] - tr.window[0]) / 1e6)
        if tr.unlinked:
            log(f"# {tr.unlinked} device ops without their launch")
    else:
        values = {"epoch_ms": window_s * 1e3 / epochs,
                  "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result.update(metrics=metrics, device=device_info)
    if trace:
        result["breakdown"] = tr.breakdown()

    prog.free()
    del losses
    t_ref = time.perf_counter()
    ref = C.reference(cell, inputs, device)
    numbers = check.numbers(mine, ref)
    log(f"# reference {time.perf_counter() - t_ref:.3f}s, numbers: "
        + json.dumps(numbers))
    ok, checks = check.judge(numbers, cell.limits)
    result["correct"] = ok and failed == 0
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    import maxk_tpu_torch  # noqa: F401  (no result without the program)

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        log(f"modules the program may not load were loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
