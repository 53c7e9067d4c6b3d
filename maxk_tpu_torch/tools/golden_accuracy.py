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
the whole one). ``golden_run`` runs one case from another init seed; it
is what ``chip_smoke.py`` and ``golden_spread.py`` run over seeds.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import tempfile
import time
from typing import Optional

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
