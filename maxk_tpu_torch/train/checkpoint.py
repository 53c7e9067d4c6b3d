"""Checkpoint / resume with torch.save.

Each checkpoint is one file ``ckpt_<epoch>.pt`` holding the model's and
the optimizer's state dicts, the epoch, the dropout generator's state
(so a resumed run draws the same dropout bits as an uninterrupted one)
and the training loop's bookkeeping blob (best_val, best_test,
best_epoch, bad_evals). The newest ``max_to_keep`` files are kept.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, ckpt_dir: str | os.PathLike, max_to_keep: int = 3):
        self._dir = Path(ckpt_dir).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self._dir / f"ckpt_{step}.pt"

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self._dir.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, blob: dict) -> None:
        """Write `blob` (state dicts, tensors, plain data) for `step`."""
        tmp = self._path(step).with_suffix(".tmp")
        torch.save(blob, tmp)
        tmp.replace(self._path(step))
        for old in self.steps()[:-self._max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def restore(self, step: Optional[int] = None) -> tuple[dict, int]:
        """(blob, step) of `step`, or of the latest checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self._dir}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True), step
