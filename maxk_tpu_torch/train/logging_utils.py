"""Logging + metric recording.

File+stream logger matching the reference's format (reference
utils/general_utils.py:13-29); scalar metrics go to a JSONL file with
TensorBoard-style tags (``train/loss`` etc. — the tags the reference
writes via tensorboardX at maxk_gnn_dgl.py:105-108), so runs remain
machine-readable without a TB dependency.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path


def get_logger(file_path: str | None,
               name: str = "maxk_tpu_torch") -> logging.Logger:
    """File+stream logger; file_path=None yields a silent logger (the
    non-zero processes of a multi-host job)."""
    logger = logging.getLogger(name if file_path else name + ".null")
    logger.handlers.clear()
    logger.propagate = False
    if file_path is None:
        logger.addHandler(logging.NullHandler())
        logger.setLevel(logging.CRITICAL)
        return logger
    formatter = logging.Formatter("%(message)s")
    fh = logging.FileHandler(file_path)
    fh.setFormatter(formatter)
    sh = logging.StreamHandler()
    sh.setFormatter(formatter)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.setLevel(logging.INFO)
    return logger


class MetricsWriter:
    """Append-only JSONL scalar writer with TB-style tags.

    log_dir=None yields a no-op writer (non-zero processes of a
    multi-host job)."""

    def __init__(self, log_dir: str | None):
        self._f = None
        if log_dir is not None:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self._path = Path(log_dir) / "scalars.jsonl"
            self._f = open(self._path, "a")
        self._t0 = time.time()

    def add_scalar(self, tag: str, value, step: int):
        if self._f is None:
            return
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "wall": round(time.time() - self._t0, 3)}
        self._f.write(json.dumps(rec) + "\n")

    def add_text(self, tag: str, text: str, step: int = 0):
        if self._f is None:
            return
        self._f.write(json.dumps({"tag": tag, "text": text,
                                  "step": int(step)}) + "\n")

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()

