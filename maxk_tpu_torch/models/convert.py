"""Carry a flax params tree across to the port's SAGE.

flax Dense kernels are (in, out) and torch ``Linear.weight`` is
(out, in); flax LayerNorm's ``scale`` is torch's ``weight``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight"}


def params_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``params`` (nested dicts of arrays) -> a torch state_dict.

    ``kernel`` -> ``weight`` transposed, ``bias`` -> ``bias``,
    LayerNorm ``scale`` -> ``weight``. Raises ValueError on a leaf name
    it does not know.
    """
    out = {}
    for module, leaves in params.items():
        if not isinstance(leaves, Mapping):
            raise ValueError(f"flax param {module!r} is not a module")
        for leaf, value in leaves.items():
            if leaf not in _LEAF_NAMES:
                raise ValueError(f"unknown flax param {module}/{leaf}")
            arr = np.array(value, dtype=np.float32)
            if leaf == "kernel":
                arr = np.ascontiguousarray(arr.T)
            out[f"{module}.{_LEAF_NAMES[leaf]}"] = torch.from_numpy(arr)
    return out
