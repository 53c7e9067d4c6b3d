"""GraphSAGE with MaxK, the configurations' ``"model": "sage"``, in plain
float32 PyTorch (``common.py``).

lin_in; then per hidden layer: MaxK; h = fc_self(h) + fc_neigh(A_mean @
h); dropout; LayerNorm (if ``norm``); then lin_out. Both branches take
the post-MaxK h (the published SAGE-MaxK layer). A_mean divides each
edge by its row's degree.
"""

from __future__ import annotations

from benchmark.reference import common as C

NORM = "mean"


def param_specs(cfg: dict, n_features: int, n_classes: int) -> dict:
    d = cfg["hidden_dim"]
    specs = {"lin_in.weight": ((d, n_features), "xavier"),
             "lin_in.bias": ((d,), "bias")}
    for i in range(cfg["hidden_layers"]):
        specs[f"fc_self_{i}.weight"] = ((d, d), "xavier")
        specs[f"fc_neigh_{i}.weight"] = ((d, d), "xavier")
        if cfg["norm"]:
            specs[f"norm_{i}.weight"] = ((d,), "scale")
            specs[f"norm_{i}.bias"] = ((d,), "bias")
    specs["lin_out.weight"] = ((n_classes, d), "xavier")
    specs["lin_out.bias"] = ((n_classes,), "bias")
    return specs


def forward(p: dict, adj: C.Adjacency, x, cfg: dict, gen, dense: str):
    """Logits; ``gen`` is the dropout generator, None in evaluation."""
    h = C.linear(x, p["lin_in.weight"], p["lin_in.bias"], dense)
    for i in range(cfg["hidden_layers"]):
        h = C.maxk(h, cfg["maxk"])
        h = (C.linear(h, p[f"fc_self_{i}.weight"], None, dense)
             + C.linear(C.aggregate(adj, h), p[f"fc_neigh_{i}.weight"],
                        None, dense))
        if gen is not None:
            h = C.dropout(h, cfg["dropout"], gen)
        if cfg["norm"]:
            h = C.layer_norm(h, p[f"norm_{i}.weight"], p[f"norm_{i}.bias"])
    return C.linear(h, p["lin_out.weight"], p["lin_out.bias"], dense)


def flops(cfg: dict, n_nodes: int, n_edges: int, n_features: int,
          n_classes: int) -> tuple[int, int]:
    """(train step, evaluation forward) model FLOPs: every Dense layer's
    forward and backward (no input gradient for lin_in) and 2 E D for each
    aggregation, forward and backward; nothing recomputed."""
    d, v, layers = cfg["hidden_dim"], n_nodes, cfg["hidden_layers"]
    dense = [C.dense_linear_flops(v, n_features, d, input_grad=False)]
    dense += [C.dense_linear_flops(v, d, d)] * (2 * layers)
    dense += [C.dense_linear_flops(v, d, n_classes)]
    agg = 2 * n_edges * d * layers
    fwd = sum(f for f, _ in dense) + agg
    return fwd + sum(b for _, b in dense) + agg, fwd


def k2_launches(cfg: dict) -> dict:
    """(launches, columns) of the aggregation kernel in a train step (one
    a layer forward, one a layer backward) and in an evaluation."""
    layers, d = cfg["hidden_layers"], cfg["hidden_dim"]
    return {"train": [(2 * layers, d)], "eval": [(layers, d)]}
