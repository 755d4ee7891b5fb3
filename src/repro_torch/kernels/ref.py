"""Plain-torch oracles for the kernels (the port of ``repro/kernels/ref.py``)."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v (BH, S, D) -> (BH, Sq, D); full S^2 softmax in f32."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    # f32 accumulation of QK^T, as preferred_element_type=f32 in the reference
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w.to(v.dtype), v)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """The gradient of ``rmsnorm_ref`` in f32: per row, with r the rsqrt of
    the mean square and xhat = x r, dx = r (dy s - xhat mean(dy s xhat))
    in x's dtype, and dscale = sum over rows of dy xhat in scale's dtype."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * r
    gs = dy.float() * scale.float()
    dx = r * (gs - xhat * torch.mean(gs * xhat, dim=-1, keepdim=True))
    dscale = (dy.float() * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def ssd_ref(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            bb: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """Exact sequential SSD recurrence (the strongest oracle -- independent
    of any chunking algebra).  xh (B,S,H,P), dt (B,S,H) f32, a (H,) f32,
    bb/cc (B,S,H,N) -> y (B,S,H,P)."""
    bsz, s, h, p = xh.shape
    n = bb.shape[-1]
    hstate = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=xh.device)
    ys = []
    for t in range(s):
        x_t, dt_t = xh[:, t].float(), dt[:, t]
        b_t, c_t = bb[:, t].float(), cc[:, t].float()
        dec = torch.exp(dt_t * a)                                # (B,H)
        hstate = hstate * dec[..., None, None] + \
            (dt_t[..., None] * x_t)[..., None] * b_t[..., None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", hstate, c_t))
    return torch.stack(ys, 1).to(xh.dtype)
