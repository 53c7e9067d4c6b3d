"""Render a benchmark suite record as the BASELINE.md suite tables — the
port's counterpart of ``tools/suite_report.py``, with the same output.

  python -m maxk_tpu_torch.tools.suite_report [BENCH_SUITE24.json]
  python -m maxk_tpu_torch.tools.suite_report --rmat BENCH_RMAT.json [BENCH_SUITE24.json]
  python -m maxk_tpu_torch.tools.suite_report --coo BENCH_COO.json

It prints (a) a per-graph markdown table (baseline, CBSR forward and
sampled backward times with their speedups, and the roofline
efficiency) and (b) the geomean forward and backward speedups over the
graphs of average degree > 50, the table the reference's analysis script
prints (main_runner_direct.py:138-213). It reads the port's records
(``python -m maxk_tpu_torch.bench.kernel_bench --json``, protocol
``torch-1``) and the JAX package's alike: both carry the same fields.

--rmat renders the topology-sensitivity table: each '<name>@rmat' row
paired with its power-law stand-in from the main suite record, with
per-phase deltas. --coo renders the COO-vs-CSR baseline comparator table
(the reference times spmm_cusparse_coo beside CSR,
kernels/spmm_cusparse.cu:65-119).
"""

from __future__ import annotations

import json
import math
import sys


def geomean(xs):
    xs = [x for x in xs if x]
    if not xs:
        return None
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def _load_rows(path):
    with open(path) as f:
        return json.load(f)["results"]


def rmat_report(rmat_path, base_path):
    base = {r["graph"]: r for r in _load_rows(base_path)}
    rrows = [r for r in _load_rows(rmat_path) if r["graph"].endswith("@rmat")]
    print(f"Topology sensitivity: R-MAT vs power-law stand-in "
          f"({len(rrows)} shapes).\n")
    print("| shape | E pow | E rmat | base pow | base rmat | Δbase | "
          "fwd16 pow | fwd16 rmat | Δfwd16 | bwd16 Δ |")
    print("|" + "---|" * 10)
    deltas = []

    def fmt(v):
        # Partially-measured rows (a run with --ks not including 16) carry
        # None per-k values; render '-' rather than a fake 0.00 ms.
        return f"{v:.2f}" if v else "-"

    for r in sorted(rrows, key=lambda r: r["n_edges"]):
        name = r["graph"].rsplit("@", 1)[0]
        b = base.get(name)
        if b is None:
            print(f"| {name} | - | {r['n_edges']} | - | "
                  f"{fmt(r['baseline_ms'])} | - | - | "
                  f"{fmt(r['forward_ms'].get('16'))} | - | - |")
            continue

        def pct(a, p):
            return f"{100.0 * (a - p) / p:+.0f}%" if (a and p) else "-"

        db = pct(r["baseline_ms"], b["baseline_ms"])
        f_r, f_p = r["forward_ms"].get("16"), b["forward_ms"].get("16")
        w_r, w_p = r["backward_ms"].get("16"), b["backward_ms"].get("16")
        print(f"| {name} | {b['n_edges']} | {r['n_edges']} "
              f"| {fmt(b['baseline_ms'])} | {fmt(r['baseline_ms'])} | {db} "
              f"| {fmt(f_p)} | {fmt(f_r)} | {pct(f_r, f_p)} "
              f"| {pct(w_r, w_p)} |")
        for a, p in ((r["baseline_ms"], b["baseline_ms"]), (f_r, f_p),
                     (w_r, w_p)):
            if a and p:
                deltas.append(abs(a - p) / p)
    if deltas:
        print(f"\nmax |delta| across phases: {100*max(deltas):.0f}%  "
              f"median {100*sorted(deltas)[len(deltas)//2]:.0f}%")


def coo_report(coo_path):
    rows = [r for r in _load_rows(coo_path) if r.get("coo_ms")]
    print(f"COO SpMM comparator vs CSR baseline ({len(rows)} graphs).\n")
    print("| graph | V | E | CSR ms | COO ms | CSR/COO |")
    print("|" + "---|" * 6)
    for r in sorted(rows, key=lambda r: r["n_edges"]):
        ratio = r["baseline_ms"] / r["coo_ms"]
        print(f"| {r['graph']} | {r['n_nodes']} | {r['n_edges']} "
              f"| {r['baseline_ms']:.2f} | {r['coo_ms']:.2f} "
              f"| {ratio:.2f}x |")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--rmat":
        rmat_report(argv[1], argv[2] if len(argv) > 2
                    else "BENCH_SUITE24.json")
        return 0
    if argv and argv[0] == "--coo":
        coo_report(argv[1])
        return 0
    path = argv[0] if argv else "BENCH_SUITE24.json"
    with open(path) as f:
        d = json.load(f)
    rows = d["results"]
    proto = d.get("protocol")
    ks = sorted({int(k) for r in rows for k in r["forward_ms"]})

    has_fused = any(r.get("fused_mask_ms") for r in rows)
    print(f"Protocol {proto}, {len(rows)} graphs"
          f"{' (PARTIAL)' if d.get('partial') else ''}.\n")
    hdr = ("| graph | V | E | deg | base ms | bwdT ms | "
           + " | ".join(f"fwd k={k}" for k in ks) + " | "
           + (" | ".join(f"fused k={k}" for k in ks) + " | "
              if has_fused else "")
           + " | ".join(f"bwd k={k}" for k in ks) + " | eff |")
    print(hdr)
    print("|" + "---|" * (hdr.count("|") - 1))
    for r in rows:
        fwd = []
        fused = []
        bwd = []
        for k in ks:
            f_ms = r["forward_ms"].get(str(k))
            s = r["baseline_ms"] / f_ms if f_ms else None
            fwd.append(f"{f_ms:.1f} ({s:.2f}x)" if f_ms else "-")
            m_ms = (r.get("fused_mask_ms") or {}).get(str(k))
            ms = r["baseline_ms"] / m_ms if m_ms else None
            fused.append(f"{m_ms:.1f} ({ms:.2f}x)" if m_ms else "-")
            b_ms = r["backward_ms"].get(str(k))
            bb = r.get("backward_baseline_ms")
            bs = bb / b_ms if (b_ms and bb) else None
            bwd.append(f"{b_ms:.1f} ({bs:.2f}x)" if bs else
                       (f"{b_ms:.1f}" if b_ms else "-"))
        eff = (r.get("roofline") or {}).get("efficiency")
        eff_cell = f"{eff:.2f}" if eff is not None else "-"
        print(f"| {r['graph']} | {r['n_nodes']} | {r['n_edges']} "
              f"| {r['avg_degree']:.1f} | {r['baseline_ms']:.2f} "
              f"| {r.get('backward_baseline_ms') or 0:.2f} | "
              + " | ".join(fwd) + " | "
              + (" | ".join(fused) + " | " if has_fused else "")
              + " | ".join(bwd)
              + f" | {eff_cell} |")

    for label, pred in (("avg-degree>50", lambda r: r["avg_degree"] > 50),
                        ("all graphs", lambda r: True)):
        sel = [r for r in rows if pred(r)]
        print(f"\nGeomeans, {label} ({len(sel)} graphs):")
        for k in ks:
            fs = geomean([r["baseline_ms"] / r["forward_ms"][str(k)]
                          for r in sel if r["forward_ms"].get(str(k))])
            bs = geomean([r["backward_baseline_ms"] / r["backward_ms"][str(k)]
                          for r in sel
                          if r["backward_ms"].get(str(k))
                          and r.get("backward_baseline_ms")])
            line = (f"  k={k}: forward {fs:.2f}x  backward {bs:.2f}x"
                    if fs and bs else f"  k={k}: forward {fs}  backward {bs}")
            if has_fused:
                fm = geomean(
                    [r["baseline_ms"] / r["fused_mask_ms"][str(k)]
                     for r in sel
                     if (r.get("fused_mask_ms") or {}).get(str(k))])
                line += (f"  fused-mask {fm:.2f}x" if fm
                         else "  fused-mask -")
            print(line)

    bad = [r["graph"] for r in rows
           if r.get("validation") and not r["validation"]["passed"]]
    print(f"\nvalidation failures: {bad or 'none'}")
    effs = sorted((r.get("roofline") or {}).get("efficiency") or 0
                  for r in rows)
    if effs:
        print(f"roofline efficiency: min {effs[0]:.2f} / "
              f"median {effs[len(effs)//2]:.2f} / max {effs[-1]:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
