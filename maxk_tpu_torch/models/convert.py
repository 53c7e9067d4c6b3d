"""Carry a flax model's variables across to the port's models.

flax Dense kernels are (in, out) and torch ``Linear.weight`` is
(out, in); flax LayerNorm's and BatchNorm's ``scale`` is torch's
``weight``. The flax models' scalar and vector params that belong to no
submodule (GCN's and GNNRes's ``gconv_bias_{i}``, GIN's ``gin_eps_{i}``)
are top-level leaves, and so are torch's. BatchNorm's ``batch_stats``
(``mean``, ``var``) are the port's running buffers. A rank of tensor
parallelism takes its own columns of every kernel (``shard``), as JAX's
``P(None, "model")`` places them.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional

import numpy as np
import torch

from maxk_tpu_torch.parallel.mesh import split_bounds

_LEAF_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_TOP_LEVEL = re.compile(r"(gconv_bias|gin_eps)_\d+$")


def params_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None,
                     shard: Optional[tuple] = None
                     ) -> dict[str, torch.Tensor]:
    """flax ``params`` (nested dicts of arrays) and optional
    ``batch_stats`` -> a torch state_dict.

    ``kernel`` -> ``weight`` transposed, ``bias`` -> ``bias``, ``scale``
    -> ``weight``, a top-level ``gconv_bias_{i}`` or ``gin_eps_{i}`` as
    it is, and ``batch_stats`` ``mean``/``var`` -> ``running_mean``/
    ``running_var``. Raises ValueError on a leaf name it does not know.
    """
    out = {}
    for module, leaves in params.items():
        if not isinstance(leaves, Mapping):
            if not _TOP_LEVEL.match(module):
                raise ValueError(f"unknown top-level flax param {module!r}")
            out[module] = torch.from_numpy(np.array(leaves, dtype=np.float32))
            continue
        for leaf, value in leaves.items():
            if leaf not in _LEAF_NAMES:
                raise ValueError(f"unknown flax param {module}/{leaf}")
            arr = np.array(value, dtype=np.float32)
            if leaf == "kernel":
                if shard is not None:
                    arr = arr[:, slice(*split_bounds(arr.shape[1],
                                                     shard[1], shard[0]))]
                arr = np.ascontiguousarray(arr.T)
            out[f"{module}.{_LEAF_NAMES[leaf]}"] = torch.from_numpy(arr)
    for module, stats in (batch_stats or {}).items():
        if not isinstance(stats, Mapping):
            raise ValueError(f"flax batch_stats {module!r} is not a module")
        for leaf, value in stats.items():
            if leaf not in _STAT_NAMES:
                raise ValueError(f"unknown flax batch_stats {module}/{leaf}")
            out[f"{module}.{_STAT_NAMES[leaf]}"] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    return out
