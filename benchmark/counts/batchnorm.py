"""BatchNorm's work over a (V, D) float32 activation, whatever implements
it: the operations and bytes of each pass a layer makes.

Bytes: each input byte read once and each output written once. A
training forward reads x and writes y; its backward reads dy and x (or
xhat, as the program keeps) and writes dx; an evaluation forward reads x
and writes y. The D-wide statistics and parameters are left out.
Operations, per element: a training forward 5 (two sums, x - mean, the
scaling, the affine), its backward 6 (two sums, the direct term, the
correction), an evaluation 3; at about one operation a byte every pass
is bytes-bound on the card.
"""

from __future__ import annotations

WORD = 4                                  # float32
# pass -> (operations, (V, D) tensors read or written) a element
PASSES = {"train_forward": (5, 2), "backward": (6, 3), "eval_forward": (3, 2)}


def pass_cost(kind: str, n_nodes: int, d: int) -> tuple[int, int]:
    """(operations, bytes) of one layer's pass ``kind`` (``PASSES``)."""
    ops, tensors = PASSES[kind]
    return ops * n_nodes * d, tensors * n_nodes * d * WORD


def least_s(layers: int, n_nodes: int, d: int, steps: int, evals: int,
            peaks: dict) -> float:
    """Least seconds of ``steps`` train steps (a forward and a backward a
    layer) and ``evals`` evaluations (a forward a layer): each pass's
    bytes at the HBM rate or its operations at the float32 peak,
    whichever is longer."""
    total = 0.0
    for kind, times in (("train_forward", steps), ("backward", steps),
                        ("eval_forward", evals)):
        ops, nbytes = pass_cost(kind, n_nodes, d)
        total += times * layers * max(ops / peaks["flops"]["float32"],
                                      nbytes / peaks["hbm_bytes"])
    return total
