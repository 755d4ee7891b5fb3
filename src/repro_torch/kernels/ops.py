"""Kernel wrappers with implementation dispatch (the port of
``repro/kernels/ops.py``).

``attention(q, k, v, impl=...)`` on the model's GQA layout:
  - "naive":   full S^2 softmax (ref.py), the no-FlashAttention baseline,
               plain torch on every device.
  - "blocked" and "pallas": flash attention.  On a CUDA tensor both run
               the Hopper kernel ("blocked" is the reference's CPU stand-in
               for its Pallas kernel); on a CPU tensor both run the plain
               blocked version.

``rmsnorm`` and ``ssd_scan`` run their Hopper kernels on CUDA tensors and
their plain versions on CPU tensors.  ``kernel_impl="plain"`` keeps every
kernel op on its plain version on the card too: a test hook, not a
fallback.

Flash attention, RMSNorm and the SSD scan go through their autograd
Functions (``FlashAttention``, ``RMSNorm``, ``SSDScan``), so the same call
serves prefill (under ``torch.inference_mode``, the forward kernel alone)
and training (the backward kernel too).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import FlashAttention, fit_block
from repro_torch.kernels.rmsnorm import RMSNorm
from repro_torch.kernels.ssd_scan import SSDScan

DEFAULT_BLOCK = 512
_fit_block = fit_block


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, impl: str = "blocked",
              block: int = DEFAULT_BLOCK,
              q_block: Optional[int] = None,
              kv_block: Optional[int] = None,
              scale: Optional[float] = None,
              kernel_impl: str = "kernel") -> torch.Tensor:
    """q (B,Sq,H,hd); k/v (B,Sk,KV,hd) with H = KV*G (GQA) -> (B,Sq,H,hd).

    ``q_block``/``kv_block`` are the plan's tiles: the plain blocked
    version tiles KV by ``kv_block`` (fitted as the reference fits it); the
    Hopper kernels run their Hopper tiles (``tiles.hopper_tile``,
    docs/port.md): at the default, forward work items of 128 query rows and
    K/V tiles of 128 keys, backward blocks of 128 keys; at ``kv_block`` 64,
    tiles and blocks of 64 keys."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if impl == "naive":
        sk = k.shape[1]
        qf = q.reshape(b, sq, kv, g, hd).permute(0, 2, 3, 1, 4) \
            .reshape(b * h, sq, hd)
        kf = k[:, :, :, None, :].expand(b, sk, kv, g, hd) \
            .permute(0, 2, 3, 1, 4).reshape(b * h, sk, hd)
        vf = v[:, :, :, None, :].expand(b, sk, kv, g, hd) \
            .permute(0, 2, 3, 1, 4).reshape(b * h, sk, hd)
        of = ref.naive_attention(qf, kf, vf, causal=causal, scale=scale)
        return of.reshape(b, kv, g, sq, hd).permute(0, 3, 1, 2, 4) \
            .reshape(b, sq, h, hd)
    if impl not in ("blocked", "pallas"):
        raise ValueError(f"attention impl {impl!r}")
    return FlashAttention.apply(q, k, v, causal, scale,
                                q_block if q_block is not None else block,
                                kv_block if kv_block is not None else block,
                                kernel_impl)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, impl: str = "pallas",
            eps: float = 1e-6, block: int = 256,
            kernel_impl: str = "kernel") -> torch.Tensor:
    """``impl="pallas"``: the RMSNorm Function over the kernel wrappers (the
    kernels on CUDA, which raise on a ``block`` that is neither the default
    nor a Hopper menu entry; the plain versions on the CPU); anything else:
    ``ref.rmsnorm_ref``, differentiated by autograd."""
    if impl == "pallas":
        return RMSNorm.apply(x, scale, eps, kernel_impl, block)
    return ref.rmsnorm_ref(x, scale, eps)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bb: torch.Tensor, cc: torch.Tensor, *, chunk: int = 256,
             return_state: bool = False, kernel_impl: str = "kernel"
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The SSD chunk scan through its autograd Function (``SSDScan``: the
    forward and backward kernels on CUDA, the plain versions on the CPU).
    Returns ``(y, hT)`` with ``return_state``, else ``(y, None)`` as the
    reference does; the reference's TPU kernel has no final state, so its
    serving handoff recomputes it in jnp, while this kernel always writes
    it.  hT carries no gradient."""
    y, hT = SSDScan.apply(xh, dt, a, bb, cc, chunk, kernel_impl)
    return y, hT if return_state else None
