"""Scaling benchmark of row-partitioned (and tensor-parallel) training:
``scaling_bench.py``'s sweep on the port.

  python -m maxk_tpu_torch.bench.scaling_bench --devices 1 2 4 --project
  python -m maxk_tpu_torch.bench.scaling_bench --devices 2 4 \\
      --model-parallel 2 --project --device cpu

Each swept size N is one spawn of N ranks (``parallel/launch.py``), a
(N/M graph x M model) grid with ``--model-parallel M``; rank r runs on
``cuda:(r % cards)``, over NCCL when each rank has a card of its own
and over gloo when they share one. The ranks take a first step, then
``--steps`` steps timed on the host clock (each ends in a device
synchronize); ``--device cpu`` runs float32 on the CPU, as the JAX
script's ``--force-cpu`` does. Ranks sharing one card, or the CPU,
measure the collectives' staging, not NVLink.

It prints the JAX script's JSON lines: for each size the halo plan
(``halo_rows``, the MB of one exchange, dense and on the CBSR wire) and
the step (``step_ms``, ``loss``, ``speedup`` and ``efficiency`` against
the first size), and with ``--project`` the NVLink projection
(``bench/roofline.py::project_multichip``). Its compute term is K2's
bytes on a shard over K2's rate: ``roofline.K2_BYTES_PER_S``, or, once a
size with one graph shard has run, the rate rank 0 measured there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

import torch

from maxk_tpu_torch.bench import roofline
from maxk_tpu_torch.data.datasets import make_synthetic_dataset
from maxk_tpu_torch.ops.cbsr import cbsr_nbytes


@dataclasses.dataclass
class Cfg:
    """The JAX script's training config."""
    model: str
    hidden_dim: int
    hidden_layers: int
    maxk: int
    compute_dtype: str
    model_parallel: int
    dropout: float = 0.1
    norm: bool = True
    nonlinear: str = "maxk"
    w_lr: float = 0.01
    w_weight_decay: float = 0.0
    enable_lookahead: bool = False
    seed: int = 97
    halo: bool = True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_size(group, job: dict) -> dict:
    """One size's work on one rank: a first step, then ``steps`` timed
    steps; on rank 0 of a grid with one graph shard, also K2 alone on
    the whole graph (its rate for the projection)."""
    from maxk_tpu_torch.bench.timing import time_fn
    from maxk_tpu_torch.ops.graph import SegmentPlan
    from maxk_tpu_torch.ops.spmm import spmm
    from maxk_tpu_torch.parallel.dist_train import DistTrainer
    cfg = job["cfg"]
    tr = DistTrainer(cfg, job["ds"], group, sharded=job["sharded"])
    dev = tr.device
    loss = float(tr.train_step())
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(job["steps"]):
        loss = tr.train_step()
    loss = float(loss)
    _sync(dev)
    out = dict(step_ms=(time.perf_counter() - t0) / job["steps"] * 1e3,
               loss=loss)
    if tr.group.size == 1 and tr.grid.world.rank == 0:
        g = tr.graphs.g_mean or tr.graphs.g_sym or tr.graphs.g_sum
        h = torch.ones(g.n_nodes, cfg.hidden_dim, device=dev)
        ms = time_fn(lambda: spmm(g, h, cfg.compute_dtype)).mean_ms
        csr = job["sharded"]._any.shards[0]
        value_bytes = 4 if cfg.compute_dtype == "float32" else 2
        out["k2_ms"] = ms
        out["k2_bytes"] = roofline.k2_bytes(
            csr.n_nodes, csr.n_edges, cfg.hidden_dim,
            SegmentPlan.build(csr), value_bytes)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="ranks to sweep (default: 1, 2, 4, 8 up to the "
                         "cards there are; 1 and 2 on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on cuda:(r %% cards)) or cpu")
    ap.add_argument("--n-nodes", type=int, default=4096)
    ap.add_argument("--avg-degree", type=float, default=16.0)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--maxk", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--model", default="sage_fused",
                    help="sage_fused exercises the CBSR halo path")
    ap.add_argument("--json", default=None)
    ap.add_argument("--project", action="store_true",
                    help="print the NVLink scaling projection of each "
                         "size (bench/roofline.py::project_multichip)")
    ap.add_argument("--nvlink-gbps", type=float, default=None,
                    help="GB/s a card receives over NVLink (default: "
                         f"H100 SXM5, {roofline.NVLINK_GBPS:g} each way)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel size (the grid's model axis); "
                         "every swept size must be divisible by it")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from maxk_tpu_torch.parallel.launch import spawn
    from maxk_tpu_torch.parallel.partition import shard_bundle
    from maxk_tpu_torch.models.models import MODEL_NORMS
    args = parse_args(argv)
    on_cpu = torch.device(args.device).type == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device} requested but CUDA is "
                           f"absent")
    cards = 0 if on_cpu else torch.cuda.device_count()
    sizes = args.devices or ([1, 2] if on_cpu else
                             [n for n in (1, 2, 4, 8) if n <= max(1, cards)])
    mp = args.model_parallel
    bad = [n for n in sizes if n % mp]
    if bad:
        raise ValueError(f"n_devices={bad[0]} not divisible by "
                         f"model_axis_size={mp}")
    print(f"# device={args.device} cards={cards} sweep={sizes} "
          f"model_parallel={mp}", file=sys.stderr)

    ds = make_synthetic_dataset(n_nodes=args.n_nodes,
                                avg_degree=args.avg_degree, n_classes=16,
                                in_size=128, seed=0)
    # bf16 is software-emulated on the CPU: float32 there, as in JAX.
    compute_dtype = "float32" if on_cpu else "bfloat16"
    value_bytes = 4 if on_cpu else 2
    cbsr_b, dense_b = cbsr_nbytes(ds.csr.n_nodes, args.maxk, args.hidden)
    print(f"# halo model per aggregation: dense all-gather "
          f"{dense_b/1e6:.1f} MB vs CBSR {cbsr_b/1e6:.1f} MB "
          f"({dense_b/cbsr_b:.1f}x reduction)", file=sys.stderr)
    norms = MODEL_NORMS.get(args.model, ("mean", "sum", "sym"))
    symmetric = getattr(ds, "symmetric", False)
    single = shard_bundle(ds.csr, 1, norms=norms, symmetric=symmetric)._any
    bytes1 = roofline.sharded_k2_bytes(single, args.hidden, value_bytes)
    rate, rate_from = roofline.K2_BYTES_PER_S, "default"

    rows = []
    base_ms = None
    for n in sizes:
        g = n // mp
        cfg = Cfg(model=args.model, hidden_dim=args.hidden,
                  hidden_layers=args.layers, maxk=args.maxk,
                  compute_dtype=compute_dtype, model_parallel=mp)
        sharded = shard_bundle(ds.csr, g, norms=norms, symmetric=symmetric)
        st = sharded._any
        if st.halo is not None:
            h = st.halo.halo_rows
            print(json.dumps(dict(
                devices=n, halo_rows=h, rows_per_shard=st.rows_per_shard,
                halo_exchange_dense_mb=round(g * g * h * args.hidden * 4
                                             / 1e6, 3),
                halo_exchange_cbsr_mb=round(g * g * h * 3 * args.maxk
                                            / 1e6, 3),
                old_allgather_mb=round(g * st.n_nodes_padded * args.hidden
                                       * 4 / 1e6, 3))), flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            ranks = spawn(run_size, n, f"file://{tmp}/store", args.device,
                          args=(dict(cfg=cfg, ds=ds, sharded=sharded,
                                     steps=args.steps),))
        ms = max(r["step_ms"] for r in ranks)
        if "k2_ms" in ranks[0]:
            rate = ranks[0]["k2_bytes"] / (ranks[0]["k2_ms"] * 1e-3)
            rate_from = f"measured on {n} ranks, 1 graph shard"
        base_ms = base_ms or ms
        rows.append(dict(devices=n, graph_shards=g, model_parallel=mp,
                         step_ms=round(ms, 3), loss=ranks[0]["loss"],
                         speedup=round(base_ms / ms, 3),
                         efficiency=round(base_ms / ms / (n / sizes[0]), 3)))
        print(json.dumps(rows[-1]), flush=True)
        if args.project:
            proj = roofline.project_multichip(
                n_shards=g,
                compute_ms_per_agg=roofline.sharded_k2_bytes(
                    st, args.hidden, value_bytes) / rate * 1e3,
                compute1_ms_per_agg=bytes1 / rate * 1e3,
                halo_rows=st.halo.halo_rows if st.halo is not None else 0,
                dim=args.hidden, k=args.maxk,
                n_aggregations=2 * args.layers,
                nvlink_gbps=args.nvlink_gbps or roofline.NVLINK_GBPS)
            proj.update(k2_bytes_per_s=rate, k2_rate=rate_from)
            print(json.dumps(dict(projection=proj)), flush=True)

    out = dict(device=args.device, model=args.model,
               n_nodes=ds.csr.n_nodes, n_edges=ds.csr.n_edges,
               hidden=args.hidden, maxk=args.maxk,
               model_parallel=mp, halo_dense_mb=dense_b / 1e6,
               halo_cbsr_mb=cbsr_b / 1e6, sweep=rows)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"# wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
