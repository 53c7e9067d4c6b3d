"""Recompute the roofline audits of a benchmark record in place — the
port's counterpart of ``tools/reaudit_suite.py``.

  python -m maxk_tpu_torch.tools.reaudit_suite BENCH_SUITE24.json

The measured times are left as they are. For each result the graph is
rebuilt on the host by name (``bench/harness.py::synthetic_by_name``, the
seed-123 generators of the suite), its segment plan with it
(``ops/graph.py::SegmentPlan``), and ``bench/roofline.py::audit_spmm``
runs again with the current H100 model and the arguments that
``benchmark_graph`` passes it. Use it after a change to the model, so
that a record's efficiencies follow the model without timing again.

Only the port's results (protocol ``torch-1``) are audited: a time taken
on another device, a TPU's, audited against an H100 model means nothing.
Results of another protocol, and graphs that are not synthetic suite
graphs, are skipped and named on stderr.
"""

from __future__ import annotations

import dataclasses
import json
import sys


def reaudit(record: dict, log=print) -> dict:
    """Rewrite each port result's ``roofline`` in `record` (in place);
    returns the record."""
    from maxk_tpu_torch.bench.harness import PROTOCOL, synthetic_by_name
    from maxk_tpu_torch.bench.roofline import audit_spmm
    from maxk_tpu_torch.ops.graph import SegmentPlan

    for r in record["results"]:
        protocol = r.get("protocol", record.get("protocol"))
        if protocol != PROTOCOL:
            print(f"# {r['graph']}: protocol {protocol!r}, not the port's "
                  f"{PROTOCOL!r}, skipped", file=sys.stderr)
            continue
        name, gen = (r["graph"].rsplit("@", 1) if "@" in r["graph"]
                     else (r["graph"], "power"))
        csr = synthetic_by_name(name, generator=gen)
        if csr is None:
            print(f"# {r['graph']}: not a synthetic suite graph, skipped",
                  file=sys.stderr)
            continue
        audit = audit_spmm(csr.n_nodes, csr.n_edges, r["dim"],
                           r["baseline_ms"], SegmentPlan.build(csr))
        old = (r.get("roofline") or {}).get("efficiency")
        r["roofline"] = dataclasses.asdict(audit)
        log(f"{r['graph']}: eff {old if old is None else round(old, 2)}"
            f" -> {audit.efficiency:.2f} ({audit.summary()})")
    return record


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    path = argv[0] if argv else "BENCH_SUITE24.json"
    with open(path) as f:
        record = json.load(f)
    reaudit(record)
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    print(f"# rewrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
