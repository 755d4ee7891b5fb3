"""Gradient compression (the port of ``repro/parallel/compression.py``):
int8 quantize/dequantize with a per-tensor scale and an optional
error-feedback residual.  On one device ``fake_compress`` only simulates
the on-the-wire int8 gradients (``Plan.grad_compression``).  ``torch.round``
rounds half to even, as ``jnp.round`` does, so both packages quantize to
the same integers.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``amax``: the max |x| of the whole tensor when ``x`` is one rank's
    shard of it (default: x's own)."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def fake_compress(grads: Dict[str, torch.Tensor],
                  amax: Optional[Callable] = None
                  ) -> Dict[str, torch.Tensor]:
    """Quantize-dequantize pass (simulates on-the-wire int8 gradients).
    ``amax(name, g)``: the whole tensor's max |g| when the grads are one
    rank's shards (``optimizer.StateSharding.global_amax``)."""
    out = {}
    for n, g in grads.items():
        q, s = quantize_int8(g, None if amax is None else amax(n, g))
        out[n] = dequantize_int8(q, s).to(g.dtype)
    return out


def compress_with_feedback(grads: Dict[str, torch.Tensor],
                           residual: Dict[str, torch.Tensor]
                           ) -> Tuple[Dict[str, torch.Tensor],
                                      Dict[str, torch.Tensor]]:
    """Error-feedback int8 compression: the residual carries the
    quantization error into the next step."""
    new_g, new_r = {}, {}
    for n, g in grads.items():
        corrected = g + residual[n]
        q, s = quantize_int8(corrected)
        deq = dequantize_int8(q, s)
        new_g[n] = deq.to(g.dtype)
        new_r[n] = (corrected - deq).to(g.dtype)
    return new_g, new_r
