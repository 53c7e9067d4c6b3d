"""Training datasets: flickr / reddit / yelp / ogbn-arxiv / ogbn-products /
ogbn-proteins (+ synthetic), matching the reference driver's loading
semantics (reference maxk_gnn_dgl.py:136-206, utils/proteins_loader.py).

Wire format. This environment has no DGL/OGB and no network egress, so real
datasets are consumed from a preprocessed ``<data_path>/<name>.npz`` with:

  indptr      (V+1,) int64/int32   CSR of the (self-loop-transformed) graph
  indices     (E,)   int32
  feat        (V, F) float32       node features
  label       (V,) int64  or (V, C) float32 for multilabel (yelp, proteins)
  train_mask / val_mask / test_mask  (V,) bool
  num_classes ()     int

``tools/convert_dgl_dataset.py`` produces these files on any machine with
dgl+ogb installed, replicating the reference's transforms: DGL AddSelfLoop
for reddit/flickr/yelp (maxk_gnn_dgl.py:138-140), OGB split->bool masks
(:167-178), and the proteins edge-feature aggregation + 112 binary targets
(utils/proteins_loader.py:42-45).

The ``synthetic`` dataset needs no files: a seeded power-law graph whose
labels are recoverable from features + neighborhood structure, so training
smoke tests show real accuracy movement.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from maxk_tpu_torch.ops.graph import CSRGraph
from maxk_tpu_torch.data.loaders import synthetic_graph


# Reference datasets and their loss/metric wiring
# (maxk_gnn_dgl.py:81-84 — BCE for yelp/proteins; :41-75 — rocauc for
# proteins, micro-F1 elsewhere).
DATASET_REGISTRY = {
    "reddit": dict(multilabel=False, metric="micro_f1"),
    "flickr": dict(multilabel=False, metric="micro_f1"),
    "yelp": dict(multilabel=True, metric="micro_f1"),
    "ogbn-arxiv": dict(multilabel=False, metric="micro_f1"),
    "ogbn-products": dict(multilabel=False, metric="micro_f1"),
    "ogbn-proteins": dict(multilabel=True, metric="rocauc"),
    "synthetic": dict(multilabel=False, metric="micro_f1"),
}


@dataclasses.dataclass
class Dataset:
    name: str
    csr: CSRGraph
    features: np.ndarray          # (V, F) float32
    labels: np.ndarray            # (V,) int64 or (V, C) float32
    train_mask: np.ndarray        # (V,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    multilabel: bool
    metric: str
    # True iff the adjacency equals its transpose INCLUDING edge values
    # (undirected graphs with unit values). Lets GraphBundle skip the
    # transpose builds (models.GraphBundle.from_csr).
    symmetric: bool = False

    @property
    def in_size(self) -> int:
        return int(self.features.shape[1])


def _load_npz(name: str, data_path: str) -> Dataset:
    path = Path(data_path) / f"{name}.npz"
    if not path.exists():
        raise FileNotFoundError(
            f"{path} not found. Preprocess the dataset on a machine with "
            f"dgl/ogb via tools/convert_dgl_dataset.py --dataset {name} "
            f"--out {data_path}")
    z = np.load(path, allow_pickle=False)
    info = DATASET_REGISTRY[name]
    labels = z["label"]
    if info["multilabel"]:
        labels = labels.astype(np.float32)
    else:
        labels = labels.astype(np.int64)
    return Dataset(
        name=name,
        csr=CSRGraph(z["indptr"].astype(np.int64),
                     z["indices"].astype(np.int32)),
        features=z["feat"].astype(np.float32),
        labels=labels,
        train_mask=z["train_mask"].astype(bool),
        val_mask=z["val_mask"].astype(bool),
        test_mask=z["test_mask"].astype(bool),
        num_classes=int(z["num_classes"]),
        multilabel=info["multilabel"],
        metric=info["metric"],
        symmetric=bool(z["symmetric"]) if "symmetric" in z.files else False,
    )


def make_synthetic_dataset(n_nodes: int = 2048, avg_degree: float = 12.0,
                           n_classes: int = 8, in_size: int = 64,
                           seed: int = 0, feature_noise: float = 1.5,
                           rewire_p: float = 0.6,
                           train_frac: float = 0.6) -> Dataset:
    """Learnable synthetic node classification.

    Labels are planted cluster ids; features are noisy label prototypes, and
    edges are rewired to prefer same-label endpoints, so both the feature
    path and the aggregation path carry signal. Higher feature_noise /
    lower train_frac make the task harder (used by the golden-accuracy
    recipe, tools/golden_accuracy.py, so accuracies stay off the 1.0
    ceiling and discriminate between k values).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_nodes)
    g = synthetic_graph(n_nodes, avg_degree, seed=seed, power_law=True)
    rows, cols = g.to_coo()
    # Rewire cross-label edges to a random same-label target w.p. rewire_p.
    cross = labels[rows] != labels[cols]
    rewire = cross & (rng.uniform(size=len(rows)) < rewire_p)
    for c in range(n_classes):
        members = np.nonzero(labels == c)[0]
        sel = rewire & (labels[rows] == c)
        cols[sel] = rng.choice(members, size=int(sel.sum()))
    csr = CSRGraph.from_coo(rows, cols.astype(np.int32), n_nodes)

    prototypes = rng.normal(size=(n_classes, in_size)).astype(np.float32)
    feat = (prototypes[labels] + feature_noise
            * rng.normal(size=(n_nodes, in_size))).astype(np.float32)

    idx = rng.permutation(n_nodes)
    n_tr = int(train_frac * n_nodes)
    n_va = int(min(0.2, (1.0 - train_frac) / 2) * n_nodes)
    train_mask = np.zeros(n_nodes, bool)
    val_mask = np.zeros(n_nodes, bool)
    test_mask = np.zeros(n_nodes, bool)
    train_mask[idx[:n_tr]] = True
    val_mask[idx[n_tr:n_tr + n_va]] = True
    test_mask[idx[n_tr + n_va:]] = True

    return Dataset(name="synthetic", csr=csr, features=feat,
                   labels=labels.astype(np.int64), train_mask=train_mask,
                   val_mask=val_mask, test_mask=test_mask,
                   num_classes=n_classes, multilabel=False,
                   metric="micro_f1")


def make_synthetic_multilabel_dataset(
        n_nodes: int = 4096, avg_degree: float = 16.0,
        n_clusters: int = 12, n_targets: int = 16, in_size: int = 64,
        seed: int = 0, feature_noise: float = 4.0, rewire_p: float = 0.7,
        train_frac: float = 0.05, label_flip: float = 0.02,
        metric: str = "micro_f1") -> Dataset:
    """Learnable multilabel synthetic dataset (yelp/proteins-style).

    Exercises the BCE-with-logits loss path and the multilabel metrics
    (micro-F1 at logit>0 for the yelp recipe, rocauc for the proteins
    recipe — reference maxk_gnn_dgl.py:81-84,41-75). Construction: the
    single-label cluster machinery plants homophilous structure, then
    each cluster activates a random ~3-of-n_targets subset and each
    node's (V, n_targets) multi-hot label is its cluster's subset with
    label_flip per-target noise, so targets are graph-predictable but
    not perfectly separable.
    """
    base = make_synthetic_dataset(
        n_nodes=n_nodes, avg_degree=avg_degree, n_classes=n_clusters,
        in_size=in_size, seed=seed, feature_noise=feature_noise,
        rewire_p=rewire_p, train_frac=train_frac)
    rng = np.random.default_rng(seed + 1)
    cluster_targets = (rng.uniform(size=(n_clusters, n_targets))
                       < 3.0 / n_targets)
    # Every cluster activates at least one target.
    for c in np.nonzero(~cluster_targets.any(axis=1))[0]:
        cluster_targets[c, rng.integers(n_targets)] = True
    labels = cluster_targets[base.labels].astype(np.float32)
    flip = rng.uniform(size=labels.shape) < label_flip
    labels = np.where(flip, 1.0 - labels, labels).astype(np.float32)
    return dataclasses.replace(
        base, labels=labels, num_classes=n_targets, multilabel=True,
        metric=metric)


def load_dataset(name: str, data_path: str = "./data/",
                 selfloop: bool = False, seed: int = 0) -> Dataset:
    """Dataset switch matching the reference driver (maxk_gnn_dgl.py:136-206).

    selfloop applies dgl.add_self_loop semantics after loading
    (maxk_gnn_dgl.py:205-206). ogbn-proteins forces out_size=112
    (maxk_gnn_dgl.py:203-204) — encoded as num_classes in the npz.
    """
    if name not in DATASET_REGISTRY:
        raise ValueError(
            f"unknown dataset {name!r}; choose from {sorted(DATASET_REGISTRY)}")
    if name == "synthetic":
        ds = make_synthetic_dataset(seed=seed)
    else:
        ds = _load_npz(name, data_path)
    if selfloop:
        ds = dataclasses.replace(ds, csr=ds.csr.add_self_loops())
    return ds
