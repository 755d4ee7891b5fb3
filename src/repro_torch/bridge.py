"""Weights and serving state across the two packages, through numpy.

The reference's flat param dict and stacked ``{k, v, pos}`` cache tree
cross by name with identical shapes.  numpy has no bf16, so bf16 crosses as
f32 (exact) and is rounded back here (exact again).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

Device = Union[str, torch.device]


def _to_torch(arr, dtype: Optional[torch.dtype], device: Device
              ) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(flat: Mapping[str, np.ndarray], *,
                      dtype: Optional[torch.dtype] = None,
                      device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor}; floating arrays cast to ``dtype``."""
    return {n: _to_torch(a, dtype, device) for n, a in flat.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """{name: tensor} -> {name: array}; bf16 becomes f32."""
    return {n: _to_numpy(t) for n, t in params.items()}


def caches_from_numpy(tree: Mapping[str, np.ndarray], *,
                      dtype: Optional[torch.dtype] = None,
                      device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """The stacked ``{k, v, pos}`` cache tree: k/v cast to ``dtype``, pos
    kept int32."""
    out = {key: _to_torch(tree[key], dtype, device) for key in ("k", "v")}
    out["pos"] = _to_torch(np.asarray(tree["pos"], np.int32), None, device)
    return out


def caches_to_numpy(caches: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(caches[key]) for key in ("k", "v", "pos")}
