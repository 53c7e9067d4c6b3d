"""GCN with MaxK, the configurations' ``"model": "gcn"``, in plain float32
PyTorch (``common.py``).

relu(lin_in); then per hidden layer: lin_i; MaxK; dropout; A_sym @ h +
gconv_bias_i (DGL's GraphConv with its weight off); LayerNorm (if
``norm``); then lin_out. A_sym divides each edge by the square root of
its row's out-degree times its column's in-degree.
"""

from __future__ import annotations

import torch

from benchmark.reference import common as C

NORM = "sym"


def param_specs(cfg: dict, n_features: int, n_classes: int) -> dict:
    d = cfg["hidden_dim"]
    specs = {"lin_in.weight": ((d, n_features), "xavier"),
             "lin_in.bias": ((d,), "bias")}
    for i in range(cfg["hidden_layers"]):
        specs[f"lin_{i}.weight"] = ((d, d), "xavier")
        specs[f"lin_{i}.bias"] = ((d,), "bias")
        specs[f"gconv_bias_{i}"] = ((d,), "bias")
        if cfg["norm"]:
            specs[f"norm_{i}.weight"] = ((d,), "scale")
            specs[f"norm_{i}.bias"] = ((d,), "bias")
    specs["lin_out.weight"] = ((n_classes, d), "xavier")
    specs["lin_out.bias"] = ((n_classes,), "bias")
    return specs


def forward(p: dict, adj: C.Adjacency, x, cfg: dict, gen, dense: str):
    """Logits; ``gen`` is the dropout generator, None in evaluation."""
    h = torch.relu(C.linear(x, p["lin_in.weight"], p["lin_in.bias"], dense))
    for i in range(cfg["hidden_layers"]):
        h = C.maxk(C.linear(h, p[f"lin_{i}.weight"], p[f"lin_{i}.bias"],
                            dense), cfg["maxk"])
        if gen is not None:
            h = C.dropout(h, cfg["dropout"], gen)
        h = C.aggregate(adj, h) + p[f"gconv_bias_{i}"]
        if cfg["norm"]:
            h = C.layer_norm(h, p[f"norm_{i}.weight"], p[f"norm_{i}.bias"])
    return C.linear(h, p["lin_out.weight"], p["lin_out.bias"], dense)


def flops(cfg: dict, n_nodes: int, n_edges: int, n_features: int,
          n_classes: int) -> tuple[int, int]:
    """(train step, evaluation forward) model FLOPs, counted as in
    ``sage.flops``."""
    d, v, layers = cfg["hidden_dim"], n_nodes, cfg["hidden_layers"]
    dense = [C.dense_linear_flops(v, n_features, d, input_grad=False)]
    dense += [C.dense_linear_flops(v, d, d)] * layers
    dense += [C.dense_linear_flops(v, d, n_classes)]
    agg = 2 * n_edges * d * layers
    fwd = sum(f for f, _ in dense) + agg
    return fwd + sum(b for _, b in dense) + agg, fwd


def k2_launches(cfg: dict) -> dict:
    """(launches, columns) of the aggregation kernel in a train step (one
    a layer forward, one a layer backward) and in an evaluation."""
    layers, d = cfg["hidden_layers"], cfg["hidden_dim"]
    return {"train": [(2 * layers, d)], "eval": [(layers, d)]}
