"""Mamba2 (SSD) block: chunked state-space dual form for prefill and a
single-step recurrence for decode (the port of ``repro/models/ssm.py``).
[arXiv:2405.21060]

The SSD scan has two routes, as in the reference: the chunked algebra of
``ssd_chunked`` in plain torch, and the SSD kernel (``kernels.ops.ssd_scan``)
when ``use_pallas`` is set and no entering state ``h0`` is given.  The
reference's TPU kernel returns no final state, so its prefill with
``return_state`` (the serving handoff) takes the plain route; the port's
kernel writes the final state, so it serves that prefill too
(docs/port.md).  Training differentiates either route: the chunked algebra
by autograd, as the reference trains, and the kernel through its autograd
Function with the SSD backward kernel (the reference's Pallas route has no
gradient, so it trains only through the algebra).  The depthwise conv, the gated norm and the decode
recurrence stay plain torch, as they are jnp in the reference, but for the
decode's gated norm, which runs the RMSNorm kernel (``mamba2_mixer``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import chunk_len, repeat_groups
from repro_torch.models.common import ExecConfig, Params, ScopedBuilder


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def num_ssm_heads(cfg: ArchConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def conv_dim(cfg: ArchConfig) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_groups * cfg.ssm_state


def init_mamba2(b: ScopedBuilder, cfg: ArchConfig):
    d = cfg.d_model
    di, h, gn = d_inner(cfg), num_ssm_heads(cfg), cfg.ssm_groups * cfg.ssm_state
    d_proj = 2 * di + 2 * gn + h
    b.add("in_proj", (d, d_proj), ("embed", "inner"), scale=1.0 / math.sqrt(d))
    b.add("conv_w", (cfg.ssm_conv, conv_dim(cfg)), (None, "inner"),
          scale=1.0 / math.sqrt(cfg.ssm_conv))
    b.add("conv_b", (conv_dim(cfg),), ("inner",), init="zeros")
    b.add("A_log", (h,), ("heads",), init="zeros")
    b.add("D", (h,), ("heads",), init="ones")
    b.add("dt_bias", (h,), ("heads",), init="zeros")
    b.add("norm_scale", (di,), ("inner",), init="ones")
    b.add("out_proj", (di, d), ("inner", "embed"), scale=1.0 / math.sqrt(di))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv; x (B,S,C), w (K,C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out + b)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                par=None) -> torch.Tensor:
    """RMS norm of y · silu(z) over d_inner.  With ``par`` (tp > 1) the
    rank holds d_inner / tp of it: its sum of squares is summed over tp,
    forward and backward (``Parallel.sum_tp``)."""
    yf = (y * F.silu(z)).float()
    if par is None:
        ms = torch.mean(yf * yf, -1, keepdim=True)
    else:
        ms = par.sum_tp(torch.sum(yf * yf, -1, keepdim=True)) \
            / (yf.shape[-1] * par.tp)
    yf = yf * torch.rsqrt(ms + 1e-6)
    return (yf * scale.float()).to(y.dtype)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bb: torch.Tensor, cc: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None, use_pallas: bool = False,
                kernel_impl: str = "kernel"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over chunks.  xh (B,S,H,P); dt (B,S,H) f32; a (H,) f32 (negative);
    bb/cc (B,S,G,N) with G dividing H (G = H is the reference's repeated
    layout).  Returns (y (B,S,H,P), final state (B,H,P,N) f32).

    With ``use_pallas`` and no ``h0`` this is the SSD kernel (``kernel_impl``
    as in ``ExecConfig``); otherwise the reference's chunked algebra, with
    its bf16 casts at the same places."""
    bsz, s, h, p = xh.shape
    q = chunk_len(chunk, s)
    nc = s // q

    if use_pallas and h0 is None:
        return kops.ssd_scan(xh, dt, a, bb, cc, chunk=q, return_state=True,
                             kernel_impl=kernel_impl)

    bb, cc = repeat_groups(bb, h), repeat_groups(cc, h)
    n = bb.shape[-1]
    xc = xh.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = bb.reshape(bsz, nc, q, h, n)
    ccc = cc.reshape(bsz, nc, q, h, n)

    da = dtc * a  # (B,C,Q,H) f32
    cum = torch.cumsum(da, dim=2)
    # intra-chunk (diagonal blocks); mask BEFORE the exp -- above the
    # diagonal rel > 0 grows with |da| and exp(rel) overflows
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,C,Qt,Qs,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    l_mat = torch.exp(torch.where(tri[None, None, :, :, None], rel,
                                  float("-inf")))
    # f32 accumulation of C B^T (preferred_element_type=f32)
    scores = torch.einsum("bcqhn,bcshn->bcqsh", ccc.float(), bc.float())
    scores = scores * l_mat * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bcqsh,bcshp->bcqhp", scores.to(xh.dtype), xc)

    # per-chunk input states
    wdec = torch.exp(cum[:, :, -1:, :] - cum) * dtc          # (B,C,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          (bc * wdec[..., None]).to(xh.dtype).float(),
                          xc.float())                        # (B,C,H,P,N) f32

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B,C,H)
    if h0 is None:
        h0 = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=xh.device)
    carry, h_prev = h0, []
    for c in range(nc):
        h_prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                      # (B,C,H,P,N)

    c_dec = (ccc * torch.exp(cum)[..., None]).to(xh.dtype)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", c_dec, h_prev.to(xh.dtype))
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, carry


def _tp_heads(p: Params, x: torch.Tensor, cfg: ArchConfig, par):
    """This tp rank's share of the mixer's inputs, for its H / tp heads.

    The param specs split the fused ``in_proj`` columns and the conv's
    channels into equal parts that are not whole heads (10448 / 4 = 2612
    columns at zamba2's width), so the rank's product ``x @ in_proj_r``
    (the sequence gathered under SP) is all-gathered over tp and the rank
    keeps z, x and dt of its own heads and all of B and C (one group: every
    head reads them); the conv's weight and bias are gathered the same way
    (``Parallel.gather_columns``, whose backward reduce-scatters: the
    ranks' B/C gradients add up).  Returns ``(zxbcdt, conv_w, conv_b,
    (d_inner, heads))`` of the rank, laid out as one device's with those
    sizes."""
    di, h, n = d_inner(cfg), num_ssm_heads(cfg), cfg.ssm_state
    if cfg.ssm_groups != 1:
        raise NotImplementedError(
            f"{cfg.ssm_groups} B/C groups under tp: the port splits the "
            "mixer for one group (ROADMAP.md, queue A: sharding on torch)")
    tp, r = par.tp, par.tp_rank
    dl, hl = di // tp, h // tp
    xs = (r * dl, (r + 1) * dl)             # its x channels
    bc = (di, di + 2 * n)                   # B and C
    (part,) = par.column(x, p["in_proj"])
    dt0 = 2 * di + 2 * n + r * hl
    zxbcdt = par.gather_columns(
        part, [xs, (di + xs[0], di + xs[1]), (di + bc[0], di + bc[1]),
               (dt0, dt0 + hl)])
    conv_w = par.gather_columns(p["conv_w"], [xs, bc])
    conv_b = par.gather_columns(p["conv_b"], [xs, bc])
    return zxbcdt, conv_w, conv_b, (dl, hl)


def mamba2_mixer(p: Params, x: torch.Tensor, cfg: ArchConfig, ec: ExecConfig,
                 cache: Optional[Dict] = None, return_state: bool = False
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B,S,D) -> (out, new_cache).  cache: {"conv": (B,K-1,convdim),
    "ssm": (B,H,P,N) f32} for decode.  return_state: populate a cache from
    a prefill pass.

    Under ``ec.par`` with tp > 1 (training) the rank runs its H / tp heads
    (``_tp_heads``) with its own slices of ``A_log``, ``D``, ``dt_bias``
    and ``norm_scale``; the gated norm sums its squares over tp, and the
    row-parallel ``out_proj``'s partial products leave summed
    (``Parallel.tp_out``: reduce-scattered along the sequence under
    SP)."""
    par = ec.par if ec.par is not None and ec.par.tp > 1 else None
    if par is not None and (cache is not None or return_state):
        raise NotImplementedError("multi-device Mamba2 serving waits for "
                                  "multi-device serving (ROADMAP.md, "
                                  "queue A: serving)")
    p_, n, g = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    if par is None:
        di, h = d_inner(cfg), num_ssm_heads(cfg)
        zxbcdt, conv_w, conv_b = x @ p["in_proj"], p["conv_w"], p["conv_b"]
    else:
        zxbcdt, conv_w, conv_b, (di, h) = _tp_heads(p, x, cfg, par)
    bsz, s = zxbcdt.shape[:2]
    cd = di + 2 * g * n
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + cd]
    dt_raw = zxbcdt[..., di + cd:]
    a = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())

    if cache is None:
        xbc_raw = xbc
        xbc = _causal_conv(xbc, conv_w, conv_b)
        # strided views of the conv output (row stride conv_dim): the kernel
        # reads them in place; B/C stay per group (the plain algebra repeats
        # them over heads as the reference does)
        xin = xbc[..., :di].reshape(bsz, s, h, p_)
        bb = xbc[..., di:di + g * n].reshape(bsz, s, g, n)
        cc = xbc[..., di + g * n:].reshape(bsz, s, g, n)
        y, h_final = ssd_chunked(xin, dt, a, bb, cc, ec.ssd_chunk,
                                 use_pallas=ec.use_pallas,
                                 kernel_impl=ec.kernel_impl)
        y = y + p["D"].to(y.dtype)[:, None] * xin
        new_cache = None
        if return_state:
            kw = cfg.ssm_conv - 1
            # a copy, so the cache does not hold the whole projection alive
            new_cache = {"conv": xbc_raw[:, -kw:].clone(), "ssm": h_final}
    else:
        # decode: conv ring buffer + single-step SSD recurrence
        conv_st = torch.cat([cache["conv"], xbc], dim=1)     # (B,K,convdim)
        xbc1 = F.silu(torch.einsum("bkc,kc->bc", conv_st, p["conv_w"])
                      + p["conv_b"])[:, None, :]
        xin = xbc1[..., :di].reshape(bsz, 1, h, p_)
        bb = xbc1[..., di:di + g * n].reshape(bsz, g, n)
        cc = xbc1[..., di + g * n:].reshape(bsz, g, n)
        rep = h // g
        bb = bb.repeat_interleave(rep, dim=1)
        cc = cc.repeat_interleave(rep, dim=1)
        dt1 = dt[:, 0]                                       # (B,H)
        dec = torch.exp(dt1 * a)                             # (B,H)
        hs = cache["ssm"] * dec[:, :, None, None] + \
            (dt1[:, :, None] * xin[:, 0].float())[..., None] \
            * bb[:, :, None, :].float()
        y = torch.einsum("bhpn,bhn->bhp", hs.to(x.dtype), cc)
        y = y + p["D"].to(y.dtype)[:, None] * xin[:, 0]
        y = y[:, None]                                       # (B,1,H,P)
        new_cache = {"conv": conv_st[:, 1:], "ssm": hs}

    if cache is None:
        y = _gated_norm(y.reshape(bsz, s, di), z, p["norm_scale"], par)
    else:
        # decode: the same norm through the RMSNorm kernel, which computes
        # each row alike whatever the batch (torch's mean over d_inner
        # sums a row in another order at batch 4 than at batch 1 on the
        # card, so a continuous-batching row would leave the batch-1
        # decode: docs/port.md); its plain version is _gated_norm's algebra
        y = kops.rmsnorm(y.reshape(bsz, s, di) * F.silu(z), p["norm_scale"],
                         eps=1e-6, block=ec.rmsnorm_block,
                         kernel_impl=ec.kernel_impl)
    if par is not None:
        return par.tp_out(y @ p["out_proj"]), None
    return y @ p["out_proj"], new_cache


def init_mamba2_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                      device="cpu") -> Dict:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, num_ssm_heads(cfg), cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }
