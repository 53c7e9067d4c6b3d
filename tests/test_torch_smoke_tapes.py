"""tests/card_tapes.py's ReluTape, on the CPU: the card's ReLU signs recorded,
then replayed onto the CPU's run, where a sign may differ only at a near
tie. Both sides run on the CPU here; the tape does not ask the device."""

import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
import card_tapes


def _x(rows: int = 6, cols: int = 16) -> torch.Tensor:
    return torch.randn(rows, cols, generator=torch.Generator().manual_seed(3))


def _record(tape, xs):
    with tape.record():
        return [torch.relu(x) for x in xs]


def test_replay_applies_the_recorded_signs_at_a_near_tie():
    x = _x()
    x[2, 5] = 1e-7              # the "card" keeps it
    tape = card_tapes.ReluTape()
    card = _record(tape, [x])[0]
    assert torch.equal(card, torch.relu(x))
    xr = x.clone()
    xr[2, 5] = -1e-7            # the "CPU" would drop it: a near tie
    xr.requires_grad_(True)
    with tape.replay():
        y = torch.relu(xr)
    assert tape.flips == 1
    keep = (x > 0).to(x.dtype)
    assert torch.equal(y.detach(), xr.detach() * keep)
    y.sum().backward()
    assert torch.equal(xr.grad, keep)
    assert torch.relu is tape.real


def test_replay_refuses_a_sign_away_from_zero():
    x = _x()
    tape = card_tapes.ReluTape()
    _record(tape, [x])
    xr = x.clone()
    i = int(torch.argmax(x[1]))
    xr[1, i] = -x[1, i]         # a flip at the row's largest |x|
    with pytest.raises(RuntimeError, match="away from 0"):
        with tape.replay():
            torch.relu(xr)
    assert torch.relu is tape.real


def test_replay_in_order_without_flips_is_relu():
    xs = [_x(), _x(3, 8) - 0.5]
    tape = card_tapes.ReluTape()
    _record(tape, xs)
    assert len(tape.xs) == 2
    with tape.replay():
        ys = [torch.relu(x) for x in xs]
    assert tape.flips == 0
    for x, y in zip(xs, ys):
        assert torch.equal(y, torch.relu(x))
