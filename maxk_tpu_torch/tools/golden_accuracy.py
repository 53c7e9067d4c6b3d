"""Golden accuracy runs of the synthetic recipe — the port's counterpart
of ``tools/golden_accuracy.py``: SAGE across k in {8, 16, 32, 64} and
relu, one maxk k = 32 and one relu run of GCN, GIN and GNN_res, then SAGE
on the multilabel recipe under both multilabel metrics, on one CUDA card
by default.

  python -m maxk_tpu_torch.tools.golden_accuracy [--only-multilabel]
  python -m maxk_tpu_torch.tools.golden_accuracy --device cpu

The recipe is the JAX tool's: the seed-97 hard synthetic dataset (V =
4096, degree 16, 12 classes, feature noise 4.0, 5 % train labels;
``GOLDEN_DATASET``), 3x64 layers, dropout 0.2, norm, float32 compute,
Adam 0.01, eval every 5 epochs, patience 10, at most 150 epochs, init
seed 97 (``Cfg``). The multilabel rows run the BCE-with-logits path on
the multilabel dataset of the same sizing (``MULTILABEL_DATASET``, 16
targets), scored by micro-F1 at logit > 0 (the yelp recipe) and by
rocauc (the ogbn-proteins recipe). BASELINE.md holds the JAX tool's rows.

Prints one JSON row a case, with the JAX tool's keys, then
``{"golden": [...]}``, or ``{"golden_multilabel": [...]}`` under
``--only-multilabel`` (a partial table, named so that it cannot pass for
the whole one). ``golden_run`` runs one case from another init seed, and
``golden_spread.py`` runs it over seeds. ``golden_runs`` runs golden rows
over their seeds (``GOLDEN_SEEDS`` and the others below) in a pool of
processes, and ``check_golden`` holds each row's mean to BASELINE.md's
row or to the JAX reference's (``tests/test_torch_card_golden.py`` on
the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import statistics
import sys
import tempfile
import time
from typing import Optional

from maxk_tpu_torch.bench.kernel_table import check

GOLDEN_DATASET = dict(n_nodes=4096, avg_degree=16.0, n_classes=12,
                      in_size=64, seed=97, feature_noise=4.0, rewire_p=0.7,
                      train_frac=0.05)
MULTILABEL_DATASET = dict(n_nodes=4096, avg_degree=16.0, n_clusters=12,
                          n_targets=16, in_size=64, seed=97,
                          feature_noise=4.0, rewire_p=0.7, train_frac=0.05)
# (model, nonlinear, k) of the single-label rows, in the JAX tool's order;
# k = 0 is relu's (the config then keeps maxk = 32, unused).
SINGLE_LABEL_CASES = (
    tuple(("sage", "maxk", k) for k in (8, 16, 32, 64))
    + (("sage", "relu", 0),)
    + tuple((m, "maxk", 32) for m in ("gcn", "gin", "gnn_res"))
    + tuple((m, "relu", 0) for m in ("gcn", "gin", "gnn_res")))
MULTILABEL_METRICS = ("micro_f1", "rocauc")
MULTILABEL_CASES = (("maxk", 32), ("relu", 0))
# Each row's best_test in BASELINE.md, by row name (golden_name), and the
# init seeds whose mean is held to it.
GOLDEN_BEST_TEST = {"sage": 0.9847, "gcn": 0.9990, "gin": 1.0000,
                    "gnn_res": 0.9948, "sage:maxk8": 0.9860,
                    "sage:maxk16": 0.9470, "sage:maxk64": 0.9941,
                    "sage:relu": 0.9844, "gcn:relu": 0.9993,
                    "gin:relu": 0.9987, "gnn_res:relu": 0.9870,
                    "sage:maxk32:micro_f1": 0.9150,
                    "sage:relu:micro_f1": 0.9175,
                    "sage:maxk32:rocauc": 0.9491,
                    "sage:relu:rocauc": 0.9494}
GOLDEN_TOL = 0.02
GOLDEN_SEEDS = tuple(range(97, 113))
# Every row but the maxk k = 32 single-label ones (GOLDEN_FLOOR_ROWS) runs
# over GOLDEN_FLOOR_SEEDS. Each BASELINE.md row is one reference draw
# (SAGE k = 16's stopped early, below its own k = 8 row), so these means
# are held from below only: at or above the row less GOLDEN_TOL.
GOLDEN_FLOOR_SEEDS = tuple(range(97, 105))
# GNN_res's golden outcome is heavy-tailed in the JAX reference too, and
# BASELINE.md's row is its seed 97 alone: the reference's own 16-seed mean
# is 0.9824 over seeds 97-112 and 0.9665 over 113-128. So GNN_res is held
# to the reference over the same 32 seeds (golden_spread.py --engine jax,
# on the CPU): its mean within GOLDEN_TOL of the reference's, and its
# count of seeds below GOLDEN_TAIL no larger than the reference's count
# allows (a one-sided Fisher exact test at GOLDEN_TAIL_P).
GOLDEN_REF = {"gnn_res": dict(seeds=tuple(range(97, 129)),
                              mean=0.9744752684672958, n_below_tail=0)}
GOLDEN_TAIL = 0.93
GOLDEN_TAIL_P = 0.05
# Golden runs at once, each in a process of its own: a run is host-bound
# and deterministic, so the pool changes its wall time, not its result.
GOLDEN_PROCS = 6


@dataclasses.dataclass
class Cfg:
    """The JAX tool's Cfg, plus the device."""
    dataset: str = "synthetic"
    model: str = "sage"
    hidden_dim: int = 64
    hidden_layers: int = 3
    dropout: float = 0.2
    norm: bool = True
    nonlinear: str = "maxk"
    maxk: int = 32
    epochs: int = 150
    w_lr: float = 0.01
    w_weight_decay: float = 0.0
    enable_lookahead: bool = False
    seed: int = 97
    selfloop: bool = False
    path: str = ""
    log_every: int = 1000
    eval_every: int = 5
    save_every: int = 0
    resume: bool = False
    timing: bool = False
    patience: int = 10          # integrated-driver style early stop
    n_devices: int = 0
    compute_dtype: str = "float32"
    device: str = "cuda"


def golden_cases(only_multilabel: bool = False) -> list:
    """(model, nonlinear, k, metric) of every row, in the JAX tool's
    order; metric None is the single-label dataset."""
    single = [] if only_multilabel else [
        (m, nl, k, None) for m, nl, k in SINGLE_LABEL_CASES]
    return single + [("sage", nl, k, metric) for metric in MULTILABEL_METRICS
                     for nl, k in MULTILABEL_CASES]


def golden_dataset(metric: Optional[str] = None, **sizes):
    """The single-label golden dataset (metric None), or the multilabel
    one scored by `metric`; `sizes` overrides the recipe's sizing."""
    from maxk_tpu_torch.data.datasets import (
        make_synthetic_dataset, make_synthetic_multilabel_dataset)
    if metric is None:
        return make_synthetic_dataset(**{**GOLDEN_DATASET, **sizes})
    return make_synthetic_multilabel_dataset(
        **{**MULTILABEL_DATASET, **sizes}, metric=metric)


@functools.cache
def _recipe_dataset(metric: Optional[str]):
    return golden_dataset(metric)


def fit_case(ds, model: str, nonlinear: str, k: int, device: str,
             prepare=None, **cfg):
    """Train one case on `ds` to its end (or early stop) in a temporary
    directory; returns the TrainResults. `cfg` overrides Cfg's fields.
    `prepare(trainer)`, if given, runs before the fit."""
    from maxk_tpu_torch.train.loop import Trainer
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(Cfg(model=model, nonlinear=nonlinear,
                              maxk=k or 32, path=tmp, device=device, **cfg),
                          ds)
        if prepare is not None:
            prepare(trainer)
        return trainer.fit()


def case_row(model: str, nonlinear: str, k: int, res,
             metric: Optional[str] = None) -> dict:
    """One printed row, with the JAX tool's keys."""
    row = dict(model=model, nonlinear=nonlinear, k=k or None)
    if metric is not None:
        row["dataset"] = f"synthetic_multilabel/{metric}"
    row.update(best_val=round(res.best_val, 4),
               best_test=round(res.best_test, 4),
               best_epoch=res.best_epoch, epochs_run=res.epochs_run,
               early_stopped=res.early_stopped)
    return row


def golden_run(model: str, seed: int, device: str = "cuda", prepare=None,
               nonlinear: str = "maxk", k: int = 32,
               metric: Optional[str] = None) -> dict:
    """One run of the golden recipe's (model, nonlinear, k, metric) case
    from init seed `seed` on `device`: its results unrounded, the
    launches of each kernel in the run, and its seconds. `prepare(trainer)`
    runs before the fit (``golden_spread.py`` loads another init or
    reseeds the dropout bits with it)."""
    from maxk_tpu_torch.ops import kernel_counters
    counted = kernel_counters()
    before = {name: fn.launches for name, fn in counted.items()}
    t0 = time.perf_counter()
    res = fit_case(_recipe_dataset(metric), model, nonlinear, k, device,
                   prepare, seed=seed)
    return dict(model=model, seed=seed, nonlinear=nonlinear, k=k or None,
                dataset=("synthetic" if metric is None
                         else f"synthetic_multilabel/{metric}"),
                best_val=res.best_val, best_test=res.best_test,
                best_epoch=res.best_epoch, epochs_run=res.epochs_run,
                launches={name: fn.launches - before[name]
                          for name, fn in counted.items()},
                seconds=round(time.perf_counter() - t0, 3))


def golden_name(model: str, nonlinear: str, k: int,
                metric: Optional[str]) -> str:
    """A golden row's name: the model alone for the single-label maxk
    k = 32 rows, else e.g. sage:maxk8, gcn:relu, sage:relu:rocauc."""
    if (nonlinear, k, metric) == ("maxk", 32, None):
        return model
    name = f"{model}:{nonlinear}{k or ''}"
    return name if metric is None else f"{name}:{metric}"


GOLDEN_CASES = {golden_name(*case): case for case in golden_cases()}
GOLDEN_FLOOR_ROWS = tuple(name for name in GOLDEN_CASES
                          if name not in ("sage", "gcn", "gin", "gnn_res"))


def golden_case_run(name: str, seed: int) -> dict:
    """golden_run of the golden row `name` on the card, tagged with it."""
    model, nonlinear, k, metric = GOLDEN_CASES[name]
    return {"row": name, **golden_run(model, seed, "cuda", None, nonlinear,
                                      k, metric)}


def tail_p(k: int, n: int, k_ref: int, n_ref: int) -> float:
    """One-sided Fisher exact p: the chance that k or more of the k +
    k_ref runs below the tail fall among the port's n runs, if the port
    and the reference (n_ref runs) share one rate."""
    tot = k + k_ref
    return sum(math.comb(n, i) * math.comb(n_ref, tot - i)
               for i in range(k, min(tot, n) + 1)) / math.comb(n + n_ref, tot)


def golden_runs(seeds_by_row: dict) -> dict:
    """The golden recipe for each row (GOLDEN_CASES) over its seeds on the
    card, GOLDEN_PROCS runs at a time in spawned processes; row -> each
    seed and the spread.

    The golden figure is one draw: one init seed under flax's init and
    JAX's dropout bits. torch's init and the card's dropout bits draw
    other numbers from the same seed, and best_test moves by about a point
    from seed to seed, so the mean over the seeds is held: to BASELINE.md's
    row, or for a model in GOLDEN_REF to the reference's over the same
    seeds, with its count of seeds below GOLDEN_TAIL."""
    import multiprocessing

    import torch
    jobs = [(name, seed) for name, seeds in seeds_by_row.items()
            for seed in seeds]
    # The longest runs first, so that the pool ends together.
    jobs.sort(key=lambda job: not job[0].startswith("gnn_res"))
    with multiprocessing.get_context("spawn").Pool(
            min(GOLDEN_PROCS, len(jobs)), initializer=torch.set_num_threads,
            initargs=(1,)) as pool:
        done = pool.starmap(golden_case_run, jobs, chunksize=1)
    return {name: golden_row(name, [r for r in done if r["row"] == name])
            for name in seeds_by_row}


def golden_row(model: str, runs: list) -> dict:
    """The golden row `model`'s runs, each seed and the spread, with what
    check_golden holds: the mean to BASELINE.md's row (from below only for
    GOLDEN_FLOOR_ROWS), or for a model in GOLDEN_REF the mean to the
    reference's and the tail's p."""
    runs = sorted(runs, key=lambda r: r["seed"])
    tests = [r["best_test"] for r in runs]
    row = dict(model=model, runs=runs, mean_best_test=statistics.mean(tests),
               median_best_test=statistics.median(tests),
               std_best_test=statistics.stdev(tests) if len(tests) > 1
               else 0.0,
               min_best_test=min(tests), max_best_test=max(tests),
               golden_best_test=GOLDEN_BEST_TEST[model],
               gap=statistics.mean(tests) - GOLDEN_BEST_TEST[model],
               tolerance=GOLDEN_TOL,
               held="floor" if model in GOLDEN_FLOOR_ROWS else "row")
    ref = GOLDEN_REF.get(model)
    if ref is not None:
        n_below = sum(t < GOLDEN_TAIL for t in tests)
        row.update(held="reference", reference_mean=ref["mean"],
                   reference_gap=row["mean_best_test"] - ref["mean"],
                   tail=GOLDEN_TAIL, n_below_tail=n_below,
                   reference_n_below_tail=ref["n_below_tail"],
                   tail_p=tail_p(n_below, len(tests), ref["n_below_tail"],
                                 len(ref["seeds"])))
    return row


def check_golden(row: dict) -> None:
    """Hold a golden_runs row as its `held` says: RuntimeError if it
    fails."""
    name = row["model"]
    if row["held"] == "floor":
        check(row["gap"] >= -GOLDEN_TOL,
              f"{name} golden mean best_test {row['mean_best_test']:.4f} "
              f"is {row['gap']:+.4f} below {row['golden_best_test']}")
        return
    if row["held"] == "row":
        check(abs(row["gap"]) <= GOLDEN_TOL,
              f"{name} golden mean best_test {row['mean_best_test']:.4f} "
              f"is {row['gap']:+.4f} from {row['golden_best_test']}")
        return
    check([r["seed"] for r in row["runs"]]
          == list(GOLDEN_REF[name]["seeds"]),
          f"{name}'s golden seeds are not the reference's")
    check(abs(row["reference_gap"]) <= GOLDEN_TOL,
          f"{name} golden mean best_test {row['mean_best_test']:.4f} is "
          f"{row['reference_gap']:+.4f} from the reference's "
          f"{row['reference_mean']:.4f} over the same seeds")
    check(row["tail_p"] >= GOLDEN_TAIL_P,
          f"{name}: {row['n_below_tail']} of {len(row['runs'])} seeds "
          f"below {GOLDEN_TAIL} against the reference's "
          f"{row['reference_n_below_tail']} (one-sided Fisher p "
          f"{row['tail_p']:.4f} < {GOLDEN_TAIL_P})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only-multilabel", action="store_true",
                    help="regenerate only the multilabel rows (the "
                         "single-label table is seeded/deterministic and "
                         "costs the most)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cpu for a CPU run)")
    args = ap.parse_args(argv)
    from maxk_tpu_torch.ops.graph import resolve_device
    resolve_device(args.device)

    rows = []
    for model, nonlinear, k, metric in golden_cases(args.only_multilabel):
        res = fit_case(_recipe_dataset(metric), model, nonlinear, k,
                       args.device)
        row = case_row(model, nonlinear, k, res, metric)
        rows.append(row)
        print(json.dumps(row), flush=True)
    key = "golden_multilabel" if args.only_multilabel else "golden"
    print(json.dumps({key: rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
