"""Kernel benchmark CLI — the port's counterpart of ``kernel_bench.py``
(the reference's ``./maxk_kernel_test [graph]``, kernels/main.cu:187-222,
and ``python main_runner_direct.py [graph]``, main_runner_direct.py:
215-307), on one CUDA card by default.

Usage:
  python -m maxk_tpu_torch.bench.kernel_bench          # all graphs in
                                                       # --graphs, or the
                                                       # synthetic suite
  python -m maxk_tpu_torch.bench.kernel_bench reddit.dgl   # one graph
  python -m maxk_tpu_torch.bench.kernel_bench --json out.json
  python -m maxk_tpu_torch.bench.kernel_bench --device cpu # CPU smoke

Graphs are the reference wire format: <name>.indptr/<name>.indices int32
binaries (kernels/util.h:8-24). Every record file names its timing
protocol and the device it was measured on (on CUDA the card's name and
power limit, as nvidia-smi gives them).
"""

from __future__ import annotations

import argparse
import json
import os.path
import sys
import traceback

from maxk_tpu_torch.bench.harness import (PROTOCOL, GraphBenchResult,
                                          analyze_speedups, benchmark_graph,
                                          device_info, measure_coo,
                                          measure_fused_mask, suite24,
                                          synthetic_by_name, synthetic_suite)
from maxk_tpu_torch.data.loaders import available_graphs, load_csr_binary
from maxk_tpu_torch.ops.graph import resolve_device


def _resume_rows(path):
    """Load a --resume-json record, keeping only rows measured under the
    CURRENT timing protocol. Rows of another protocol (the JAX package's
    TPU records among them) are dropped and re-measured."""
    if not path or not os.path.exists(path):
        return [], []
    with open(path) as f:
        prior = json.load(f).get("results", [])
    rows = [GraphBenchResult.from_json(r) for r in prior]
    keep = [r for r in rows if r.protocol == PROTOCOL]
    stale = sorted(r.graph for r in rows if r.protocol != PROTOCOL)
    return keep, stale


def _fill_column(args, label, lacks, measure):
    """Measure ONE missing column for resume-JSON rows that lack it.

    Regenerates each graph by name (binary dir first, synthetic suite
    fallback — same resolution as the main path), runs ONLY `measure`
    (which mutates the row in place), and rewrites --json with the
    augmented rows after every graph. Backs --fill-fused-mask and
    --fill-coo."""
    src = args.resume_json or args.json
    rows, stale = _resume_rows(src)
    with open(src) as f:
        record = json.load(f)   # preserve partial/geomean/protocol keys
    if stale:
        print(f"# fill: {len(stale)} stale-protocol rows left untouched: "
              f"{', '.join(stale)}", file=sys.stderr)
    only = set(args.only or [])
    todo = [r for r in rows if lacks(r)
            and (not only or r.graph in only)]
    print(f"# fill-{label}: {len(todo)}/{len(rows)} rows to measure",
          file=sys.stderr)
    binaries = set(available_graphs(args.graphs))
    for r in todo:
        stem, gen = (r.graph.rsplit("@", 1) if "@" in r.graph
                     else (r.graph, "power"))
        if stem in binaries:
            csr = load_csr_binary(args.graphs, stem)
        else:
            csr = synthetic_by_name(stem, generator=gen)
        if csr is None:
            print(f"# {r.graph}: no graph source, skipped", file=sys.stderr)
            continue
        print(f"# {r.graph}: V={csr.n_nodes} E={csr.n_edges}",
              file=sys.stderr)
        try:
            measure(r, csr)
        except Exception as e:  # noqa: BLE001 — keep filling other rows
            print(f"# {r.graph}: FAILED ({type(e).__name__}: "
                  f"{str(e)[:200]})", file=sys.stderr)
            continue
        if args.json:
            # Only the measured rows change in place (stale-protocol rows
            # pass through untouched).
            filled = {x.graph: x.as_json() for x in rows}
            record["results"] = [filled.get(orig.get("graph"), orig)
                                 for orig in record["results"]]
            with open(args.json, "w") as f:
                json.dump(record, f, indent=2)
    return 0


def _fill_fused_mask(args):
    def measure(r, csr):
        ks = sorted(r.forward_ms) or list(args.ks)
        r.fused_mask_ms = measure_fused_mask(csr, dim=r.dim, ks=ks,
                                             device=args.device)

    return _fill_column(args, "fused-mask",
                        lambda r: not r.fused_mask_ms, measure)


def _fill_coo(args):
    def measure(r, csr):
        r.coo_ms = measure_coo(csr, dim=r.dim, device=args.device)

    return _fill_column(args, "coo", lambda r: not r.coo_ms, measure)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("graph", nargs="?", default=None,
                    help="single graph name (default: traverse all)")
    ap.add_argument("--graphs", default="./graphs",
                    help="dir with <name>.indptr/.indices binaries")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--ks", type=int, nargs="+", default=[16, 32, 64])
    ap.add_argument("--no-validate", action="store_true")
    ap.add_argument("--no-gnna", action="store_true")
    ap.add_argument("--coo", action="store_true",
                    help="also time the COO SpMM baseline (the reference's "
                         "cuSPARSE COO path; index_add_ comparator)")
    ap.add_argument("--no-fused-mask", action="store_true",
                    help="skip the mask-route fused forward column "
                         "(fused_mask_ms: the production training route)")
    ap.add_argument("--fill-fused-mask", action="store_true",
                    help="targeted augmentation: measure ONLY fused_mask_ms "
                         "for rows in --resume-json that lack it, rewrite "
                         "--json, and exit (no other columns touched)")
    ap.add_argument("--fill-coo", action="store_true",
                    help="targeted augmentation: measure ONLY coo_ms "
                         "for rows in --resume-json that lack it (same "
                         "contract as --fill-fused-mask)")
    ap.add_argument("--only", nargs="+", default=None,
                    help="restrict a --fill-* pass to these row names")
    ap.add_argument("--large", action="store_true",
                    help="include reddit/products-scale synthetic shapes "
                         "(minutes of host generation)")
    ap.add_argument("--suite24", action="store_true",
                    help="run the 24-graph shape-stand-in suite "
                         "(harness.SUITE24_SPECS) instead of the default "
                         "synthetic suite")
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("--resume-json", default=None,
                    help="load finished graphs from this results JSON and "
                         "skip them (continue an interrupted suite run); "
                         "typically the same path as --json")
    ap.add_argument("--generator", default="power",
                    choices=["power", "rmat"],
                    help="synthetic suite-graph generator: 'rmat' re-runs "
                         "the same (V, degree) shapes under R-MAT topology; "
                         "result names get an '@rmat' suffix")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cpu for a smoke run)")
    return ap.parse_args(argv)


def _write(path, results, device, **extra):
    with open(path, "w") as f:
        json.dump(dict(protocol=PROTOCOL, device=device,
                       results=[r.as_json() for r in results], **extra),
                  f, indent=2)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)

    if args.fill_fused_mask:
        return _fill_fused_mask(args)
    if args.fill_coo:
        return _fill_coo(args)

    if args.graph:
        stem = args.graph.removesuffix(".indptr")
        if stem in available_graphs(args.graphs):
            graphs = [(stem, load_csr_binary(args.graphs, stem))]
        else:
            # Fall back to a synthetic-suite graph by name. A
            # '@<generator>' suffix in the name selects that generator.
            generator = args.generator
            if "@" in stem:
                stem, generator = stem.rsplit("@", 1)
            g = synthetic_by_name(stem, generator=generator)
            if g is None:
                print(f"# {stem}: no binary under {args.graphs} and no "
                      f"synthetic suite graph of that name", file=sys.stderr)
                return 2
            if generator != "power":
                stem = f"{stem}@{generator}"
            graphs = [(stem, g)]
    elif args.suite24:
        keep, _ = _resume_rows(args.resume_json)
        graphs = suite24(skip=frozenset(r.graph for r in keep),
                         generator=args.generator)
    else:
        names = available_graphs(args.graphs)
        if names:
            graphs = [(n, load_csr_binary(args.graphs, n)) for n in names]
        else:
            print(f"# no binary graphs under {args.graphs}; "
                  f"using synthetic suite", file=sys.stderr)
            graphs = synthetic_suite(large=args.large)

    results = []
    done = set()
    if args.resume_json:
        results, stale = _resume_rows(args.resume_json)
        done = {r.graph for r in results}
        if done:
            print(f"# resume: {len(done)} graphs already measured "
                  f"({', '.join(sorted(done))})", file=sys.stderr)
        if stale:
            print(f"# resume: {len(stale)} stale-protocol rows dropped, "
                  f"will re-measure: {', '.join(stale)}", file=sys.stderr)

    device = device_info(args.device)
    print("num graph dim_origin dim_k kernel time(ms)")
    errors = []
    for name, csr in graphs:
        if name in done:
            continue
        print(f"# {name}: V={csr.n_nodes} E={csr.n_edges} "
              f"avg_deg={csr.avg_degree:.1f}", file=sys.stderr)
        try:
            results.append(benchmark_graph(
                csr, name, dim=args.dim, ks=tuple(args.ks),
                validate=not args.no_validate, run_gnna=not args.no_gnna,
                run_coo=args.coo, run_fused_mask=not args.no_fused_mask,
                device=args.device))
        except Exception as e:  # noqa: BLE001 — a suite traversal must
            # not lose the remaining graphs to one failure (an
            # out-of-memory giant, say). The failure is recorded, the run
            # continues, and the exit code says so.
            print(f"# {name}: FAILED ({type(e).__name__}: "
                  f"{str(e)[:300]})", file=sys.stderr)
            traceback.print_exc(limit=8)
            errors.append(name)
            continue
        if args.json:
            # Rewrite after every graph: a long suite must not lose
            # finished results to a crash on a later graph.
            _write(args.json, results, device, partial=True)

    summary = analyze_speedups(results)

    failed = [r.graph for r in results
              if r.validation and not r.validation["passed"]]
    if failed:
        print(f"\nVALIDATION FAILURES: {failed}", file=sys.stderr)

    if args.json:
        _write(args.json, results, device, geomean_speedups=summary)
        print(f"# wrote {args.json}", file=sys.stderr)

    if errors:
        print(f"\nBENCH ERRORS (not measured): {errors}", file=sys.stderr)
    return 1 if (failed or errors) else 0


if __name__ == "__main__":
    sys.exit(main())
