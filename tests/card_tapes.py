"""Tapes that hold a model's choices on the card to its run on the CPU
(``tests/test_torch_card_models.py``; on the CPU,
``tests/test_torch_smoke_tapes.py``).

A near tie may fall either way on two devices: a row whose k-th and
(k+1)-th largest values lie closer than the two devices' roundings of
them, or an entry within rounding of 0 under ReLU. One flip moves an
output entry by the entry's size and spreads through the graph (in
GNN_res a flipped entry before BatchNorm's backward reaches a whole
column). So the card's run records the x of every call (``record``),
and the CPU's run, making the same calls in the same order
(``replay``), checks that its own choice is the card's except at near
ties (counted in ``flips``), then applies the card's choice.
"""

import contextlib

import torch

from maxk_tpu_torch.bench.kernel_table import check


class MaxKTape:
    """Holds a model's MaxK choices on the card to its run on the CPU.

    ``record`` patches ``module.maxk`` to keep each x (the card's own K1
    launches untouched); ``replay`` checks that the CPU's top k of its own
    x is the card's choice in every row except near ties (gap <= TIE_RTOL
    of the row's largest |x|), then applies the card's choice: y = x *
    mask, so dx = g * mask. The card's choice is the plain version's on
    the card's x, which the K1 tests hold K1 bit-equal to; a K1 that
    chose otherwise would show in the outputs.
    """

    TIE_RTOL = 1e-4

    def __init__(self, module):
        self.module = module
        self.real = module.maxk
        self.xs = []
        self.flips = 0

    @contextlib.contextmanager
    def _patched(self, fn):
        self.module.maxk = fn
        try:
            yield
        finally:
            self.module.maxk = self.real

    def record(self):
        def rec(x, k):
            self.xs.append(x.detach().clone())
            return self.real(x, k)
        return self._patched(rec)

    def replay(self):
        from maxk_tpu_torch.ops.cuda_topk import maxk_forward_plain
        recorded = iter(self.xs)

        def rep(x, k):
            x_card = next(recorded)
            mask = maxk_forward_plain(x_card, k)[1].to(x.device, x.dtype)
            own = maxk_forward_plain(x.detach(), k)[1].to(x.dtype)
            rows = (own != mask).any(dim=1)
            if bool(rows.any()):
                xr = x.detach()[rows]
                top = torch.topk(xr, k + 1, dim=1).values
                gap = top[:, k - 1] - top[:, k]
                check(bool((gap <= self.TIE_RTOL
                            * xr.abs().amax(dim=1)).all()),
                      f"the card's top {k} differs from the CPU's in a "
                      f"row without a near tie (gaps {gap.tolist()[:8]})")
                self.flips += int(rows.sum())
            return x * mask
        return self._patched(rep)


class ReluTape:
    """Holds a model's ReLU signs on the card to its run on the CPU, as
    MaxKTape holds its MaxK choices: ``record`` patches ``torch.relu``;
    ``replay`` checks that the CPU's signs are the card's except at near
    ties (|x| <= TIE_RTOL of the row's largest |x|), then applies the
    card's: y = x * (x_card > 0), so dx = g * (x_card > 0).
    """

    TIE_RTOL = 1e-4

    def __init__(self):
        self.real = torch.relu
        self.xs = []
        self.flips = 0

    @contextlib.contextmanager
    def _patched(self, fn):
        torch.relu = fn
        try:
            yield
        finally:
            torch.relu = self.real

    def record(self):
        def rec(x):
            self.xs.append(x.detach().clone())
            return self.real(x)
        return self._patched(rec)

    def replay(self):
        recorded = iter(self.xs)

        def rep(x):
            keep = (next(recorded) > 0).to(x.device)
            own = x.detach() > 0
            differ = own != keep
            if bool(differ.any()):
                xd = x.detach().reshape(-1, x.shape[-1])
                near = (xd.abs() <= self.TIE_RTOL
                        * xd.abs().amax(dim=1, keepdim=True))
                check(bool(near.reshape(x.shape)[differ].all()),
                      "the card's ReLU sign differs from the CPU's away "
                      f"from 0 (|x| {x.detach()[differ].abs().max():.3g})")
                self.flips += int(differ.sum())
            return x * keep.to(x.dtype)
        return self._patched(rep)
