"""GNN_res with MaxK, the configurations' ``"model": "gnn_res"``, in plain
float32 PyTorch (``common.py``).

relu(lin_in); then per hidden layer: r = res_i(h); h = A_sym @ h +
gconv_bias_i (DGL's GraphConv with its weight off, on the dense h);
BatchNorm (if ``norm``); h = relu(lin1_i(h)); dropout; h =
MaxK(lin2_i(h)); h = relu(r + h); dropout; then lin_out. A_sym divides
each edge by the square root of its row's out-degree times its column's
in-degree. A training forward draws two dropout masks a layer, in that
order.

BatchNorm is flax's, over all rows: a training forward normalises with
the batch's biased statistics, the variance E[x^2] - E[x]^2 clamped at
0, and moves the running ones to 0.99 running + 0.01 batch, in place;
an evaluation (no dropout generator) normalises with the running ones.
Eps is 1e-5. The running statistics are the model's state
(``state_specs``), drawn like biases and scales so that an evaluation on
them reads statistics other than the batch's.

BatchNorm's training backward, relu then dropout, and MaxK
(``common.masked``) keep only what their gradients need, xhat and 0/1
masks as bool, so that three steps at the ogbn-products shape fit on one
80 GB card (51 GiB; plain autograd of the same ops overran it).

Departures from the published model (MaxK-GNN ``utils/models.py:394-454``),
which the program shares: the published BatchNorm is torch's
``BatchNorm1d``, which moves the running statistics by 0.9 running + 0.1
batch and keeps the unbiased batch variance for them; here, as in the
program, the model is the JAX package's flax one.
"""

from __future__ import annotations

import torch

from benchmark.reference import common as C

NORM = "sym"
MOMENTUM = 0.99
EPS = 1e-5


def param_specs(cfg: dict, n_features: int, n_classes: int) -> dict:
    d = cfg["hidden_dim"]
    specs = {"lin_in.weight": ((d, n_features), "xavier"),
             "lin_in.bias": ((d,), "bias")}
    for i in range(cfg["hidden_layers"]):
        specs[f"res_{i}.weight"] = ((d, d), "xavier")
        specs[f"res_{i}.bias"] = ((d,), "bias")
        specs[f"gconv_bias_{i}"] = ((d,), "bias")
        if cfg["norm"]:
            specs[f"norm_{i}.weight"] = ((d,), "scale")
            specs[f"norm_{i}.bias"] = ((d,), "bias")
        for lin in ("lin1", "lin2"):
            specs[f"{lin}_{i}.weight"] = ((d, d), "xavier")
            specs[f"{lin}_{i}.bias"] = ((d,), "bias")
    specs["lin_out.weight"] = ((n_classes, d), "xavier")
    specs["lin_out.bias"] = ((n_classes,), "bias")
    return specs


def state_specs(cfg: dict, n_features: int, n_classes: int) -> dict:
    """The BatchNorm running statistics; "scale" keeps the variance
    positive."""
    d, specs = cfg["hidden_dim"], {}
    if cfg["norm"]:
        for i in range(cfg["hidden_layers"]):
            specs[f"norm_{i}.running_mean"] = ((d,), "bias")
            specs[f"norm_{i}.running_var"] = ((d,), "scale")
    return specs


class _BatchNormTrain(torch.autograd.Function):
    """(h - mean) / sqrt(var + eps) * w + b with the batch's statistics
    of h, differentiated through them too: dh = rstd (g - mean(g) - xhat
    mean(g xhat)), g = dy w. Only xhat = (h - mean) rstd is kept."""

    @staticmethod
    def forward(ctx, h, w, b, mean, var):
        rstd = torch.rsqrt(var + EPS)
        xhat = (h - mean) * rstd
        ctx.save_for_backward(xhat, rstd, w)
        return xhat * w + b

    @staticmethod
    def backward(ctx, dy):
        xhat, rstd, w = ctx.saved_tensors
        g = dy * w
        dh = rstd * (g - g.mean(dim=0) - xhat * (g * xhat).mean(dim=0))
        return dh, (dy * xhat).sum(dim=0), dy.sum(dim=0), None, None


def batch_norm(h: torch.Tensor, p: dict, name: str,
               training: bool) -> torch.Tensor:
    mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if not training:
        return (h - mean) * torch.rsqrt(var + EPS) * w + b
    with torch.no_grad():
        batch_mean = h.mean(dim=0)
        batch_var = torch.clamp((h * h).mean(dim=0)
                                - batch_mean * batch_mean, min=0.0)
        mean.copy_(MOMENTUM * mean + (1 - MOMENTUM) * batch_mean)
        var.copy_(MOMENTUM * var + (1 - MOMENTUM) * batch_var)
    return _BatchNormTrain.apply(h, w, b, batch_mean, batch_var)


def relu_dropout(x: torch.Tensor, p: float, gen) -> torch.Tensor:
    """relu(x), then, with a generator, ``common.dropout``'s draw and
    scale; only the 0/1 mask of both is kept for the backward."""
    if gen is None:
        return torch.relu(x)
    mask = (x > 0) & C.keep_mask(x, p, gen)
    return C.masked(x / (1.0 - p), mask)


def forward(p: dict, adj: C.Adjacency, x, cfg: dict, gen, dense: str):
    """Logits; ``gen`` is the dropout generator, None in evaluation. ``p``
    holds the parameters and the state; a training forward updates the
    state."""
    C.no_tf32()
    h = torch.relu(C.linear(x, p["lin_in.weight"], p["lin_in.bias"], dense))
    for i in range(cfg["hidden_layers"]):
        r = C.linear(h, p[f"res_{i}.weight"], p[f"res_{i}.bias"], dense)
        h = C.aggregate(adj, h) + p[f"gconv_bias_{i}"]
        if cfg["norm"]:
            h = batch_norm(h, p, f"norm_{i}", gen is not None)
        h = relu_dropout(C.linear(h, p[f"lin1_{i}.weight"],
                                  p[f"lin1_{i}.bias"], dense),
                         cfg["dropout"], gen)
        h = C.maxk(C.linear(h, p[f"lin2_{i}.weight"], p[f"lin2_{i}.bias"],
                            dense), cfg["maxk"])
        h = relu_dropout(r + h, cfg["dropout"], gen)
    return C.linear(h, p["lin_out.weight"], p["lin_out.bias"], dense)


def flops(cfg: dict, n_nodes: int, n_edges: int, n_features: int,
          n_classes: int) -> tuple[int, int]:
    """(train step, evaluation forward) model FLOPs, counted as in
    ``sage.flops``: lin_in, then res_i, lin1_i and lin2_i a layer, and
    lin_out; 2 E D for each aggregation, forward and backward."""
    d, v, layers = cfg["hidden_dim"], n_nodes, cfg["hidden_layers"]
    dense = [C.dense_linear_flops(v, n_features, d, input_grad=False)]
    dense += [C.dense_linear_flops(v, d, d)] * (3 * layers)
    dense += [C.dense_linear_flops(v, d, n_classes)]
    agg = 2 * n_edges * d * layers
    fwd = sum(f for f, _ in dense) + agg
    return fwd + sum(b for _, b in dense) + agg, fwd


def k2_launches(cfg: dict) -> dict:
    """(launches, columns) of the aggregation kernel in a train step (one
    a layer forward, one a layer backward) and in an evaluation."""
    layers, d = cfg["hidden_layers"], cfg["hidden_dim"]
    return {"train": [(2 * layers, d)], "eval": [(layers, d)]}
