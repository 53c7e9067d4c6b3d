"""The readings that a cell's limits are set from, in one process.

  python -m benchmark.readings --workload <name> --seeds <n> ...

For each seed: the cell's inputs, the program's Trainer and its first
steps, exactly as a run's set-up makes them (no window), then the plain
reference; one line of the compared numbers. For the first CONTROL_SEEDS
seeds also the control (the reference with TF32 Dense products) and the
fault "half of the batch left out" (the reference's loss over half of the
training nodes), each against the reference. A state left unchanged
reads 1 on ``change_gap`` by its definition, and running statistics left
unchanged 1 on ``state_gap``; neither is run. Ends with the
largest program reading and the smallest control and fault readings of
each number.
"""

from __future__ import annotations

import argparse
import json
import sys

CONTROL_SEEDS = 3


def readings(cell, seed: int, device: str, control: bool) -> dict:
    from benchmark import cell as C
    from benchmark.check import numbers

    inputs = C.make_inputs(cell, seed, device)
    prog = C.Program(cell, inputs, seed, device)
    mine = prog.first_steps(inputs)
    prog.free()
    ref = C.reference(cell, inputs, device)
    out = {"seed": seed, "program": numbers(mine, ref),
           "losses": mine.losses, "reference_losses": ref.losses}
    if control:
        for side, kw in (("control", {"dense": "tf32"}),
                         ("half_batch", {"half_batch": True})):
            out[side] = numbers(
                C.reference(cell, inputs, device, **kw), ref)
    return out


def summary(lines: list) -> dict:
    """The largest program reading and the smallest of each other side."""
    out = {}
    for side, pick in (("program", max), ("control", min),
                       ("half_batch", min)):
        got = [ln[side] for ln in lines if side in ln]
        if got:
            out[side] = {k: pick(g[k] for g in got) for k in got[0]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from benchmark.spec import load_cell

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    lines = []
    for i, seed in enumerate(args.seeds):
        lines.append(readings(cell, seed, "cuda", i < CONTROL_SEEDS))
        print(json.dumps(lines[-1]), flush=True)
    print(json.dumps({"workload": args.workload,
                      "summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
