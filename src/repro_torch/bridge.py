"""Weights and serving state across the two packages, through numpy.

The reference's flat param dict (stacked names included: ``(L, ...)`` and
the hybrid's ``(groups, per, ...)``) and its cache trees (the dense
``{k, v, pos}`` and the hybrid's nested ``{"attn", "mamba"}``) cross by
name with identical shapes.  numpy has no bf16, so bf16 crosses as
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


def caches_from_numpy(tree: Mapping, *, dtype: Optional[torch.dtype] = None,
                      device: Device = "cpu") -> Dict:
    """A cache tree -- dense ``{k, v, pos}`` or the hybrid's ``{"attn":
    {k, v, pos}, "mamba": {conv, ssm}}`` -- leaf by leaf: ``pos`` as int32,
    the SSM state ``ssm`` as f32 (it is f32 in both packages), every other
    floating leaf cast to ``dtype``."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out[key] = caches_from_numpy(val, dtype=dtype, device=device)
        elif key == "pos":
            out[key] = _to_torch(np.asarray(val, np.int32), None, device)
        else:
            out[key] = _to_torch(val, torch.float32 if key == "ssm"
                                 else dtype, device)
    return out


def caches_to_numpy(caches: Mapping) -> Dict:
    """The same tree with numpy leaves; bf16 becomes f32."""
    return {key: caches_to_numpy(val) if isinstance(val, Mapping)
            else _to_numpy(val) for key, val in caches.items()}
