"""Optimizers: Adam (+ L2 weight decay) with an optional Lookahead wrapper.

``torch.optim.Adam(weight_decay=)`` adds the decay to the gradient, which
is what the JAX package's ``optax.add_decayed_weights`` + ``adam`` chain
does. Lookahead: every k steps the slow weights move alpha of the way
toward the fast weights and the fast weights are reset to them; the slow
buffer is initialised to the fast weights at the first sync, so the first
sync is an init, not a blend.
"""

from __future__ import annotations

from typing import Iterable

import torch


class Lookahead:
    """Lookahead around an inner optimizer (step / zero_grad /
    state_dict / load_state_dict, as a torch optimizer)."""

    def __init__(self, inner: torch.optim.Optimizer, alpha: float = 0.5,
                 k: int = 6):
        self.inner = inner
        self.alpha = alpha
        self.k = k
        self.params = [p for g in inner.param_groups for p in g["params"]]
        self.slow = None          # list of tensors after the first sync
        self.n_steps = 0

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        self.inner.step()
        self.n_steps += 1
        if self.n_steps % self.k:
            return
        if self.slow is None:
            self.slow = [p.detach().clone() for p in self.params]
            return
        for s, p in zip(self.slow, self.params):
            s.add_(p - s, alpha=self.alpha)
            p.copy_(s)

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "slow": self.slow,
                "n_steps": self.n_steps}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.n_steps = state["n_steps"]
        self.slow = None if state["slow"] is None else [
            s.to(p.device) for s, p in zip(state["slow"], self.params)]


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.0,
                   enable_lookahead: bool = False,
                   lookahead_alpha: float = 0.5, lookahead_k: int = 6):
    """Adam with L2 weight decay, optionally wrapped in Lookahead."""
    opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    if enable_lookahead:
        return Lookahead(opt, alpha=lookahead_alpha, k=lookahead_k)
    return opt
