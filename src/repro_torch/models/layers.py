"""Core layers: norms, rotary embeddings, the gated MLP and GQA attention
(the port of ``repro/models/layers.py``).

Every layer is an (init, apply) pair over flat-dict params.  Attention
covers prefill (full sequence, ``cache=None``) and decode (one token
against a KV cache) at a scalar ``pos`` (lock-step decode) or a ``(B,)``
vector of per-request positions (the continuous-batching engine,
``serving/``), against a bf16 cache or the int8 one (codes plus f32
per-(token, head) scales, ``quantize_kv``).  The prefill route is
differentiable: the projections, RoPE, flash attention and the norm carry
gradients, the latter two through their kernels' autograd Functions.  The
QKV biases (``cfg.qkv_bias``, qwen2-moe) are added after the projections,
before the rotation, in training, prefill and decode alike.  MLA and
cross-attention wait for their slices (ROADMAP.md).

On a rank of a multi-device serving plan (``ExecConfig.par``) the rank
runs its query heads; its cache holds what ``sharding.cache_specs`` gives
it: its own KV heads where tp divides them, else every KV head, and all
positions or, where a group splits the KV sequence
(``ExecConfig.kv_split``), its part of them, decoded as flash-decoding
does and merged over the group (``_split_sdpa``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (ExecConfig, Params, ScopedBuilder,
                                       all_gather_dim)

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(b: ScopedBuilder, cfg: ArchConfig):
    b.add("scale", (cfg.d_model,), ("embed",), init="ones")
    if cfg.norm_type == "layernorm":
        b.add("bias", (cfg.d_model,), ("embed",), init="zeros")


def norm(p: Params, x: torch.Tensor, cfg: ArchConfig,
         ec: Optional[ExecConfig] = None) -> torch.Tensor:
    """RMSNorm goes through ``ops.rmsnorm``, the RMSNorm kernels' autograd
    Function, with ``ec``'s ``kernel_impl`` and ``rmsnorm_block`` (the
    defaults without one); LayerNorm stays plain torch."""
    if cfg.norm_type == "rmsnorm":
        ec = ec if ec is not None else ExecConfig()
        return kops.rmsnorm(x, p["scale"], eps=1e-6, block=ec.rmsnorm_block,
                            kernel_impl=ec.kernel_impl)
    dtype = x.dtype
    xf = x.float()
    xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + 1e-6) * p["scale"].float() + p["bias"].float()
    return xf.to(dtype)


# ---------------------------------------------------------------------------
# Rotary
# ---------------------------------------------------------------------------


def rope_freqs(positions: torch.Tensor, dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., dim//2), f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, d); cos/sin (..., S, d//2) broadcast over heads.  The
    split-halves convention: (x1, x2) are the two halves of the last dim."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(b: ScopedBuilder, cfg: ArchConfig):
    if not cfg.mlp_gated:
        raise NotImplementedError("the ungated MLP is not ported yet "
                                  "(ROADMAP.md, queue A: remaining families)")
    d, f = cfg.d_model, cfg.d_ff
    b.add("wg", (d, f), ("embed", "mlp"))
    b.add("wu", (d, f), ("embed", "mlp"))
    b.add("wd", (f, d), ("mlp", "embed"))


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


class _GatedDown(torch.autograd.Function):
    """``(act(g) * u) @ wd`` that saves only g, u and wd: the backward
    takes act(g) and the gated product again, the same ops on the same
    inputs, so its gradients are autograd's.  Eager autograd would also
    keep act(g) and the product, two (tokens, d_ff) tensors a layer that
    the memory model does not charge (XLA recomputes such elementwise
    work).  A 3-D ``wd`` is a stack of experts' (the MoE's ``(E, f, d)``),
    with g and u ``(E, rows, f)``: the product is batched over E."""
    @staticmethod
    def forward(ctx, g, u, wd, kind):
        ctx.kind = kind
        ctx.save_for_backward(g, u, wd)
        return (_act(g, kind) * u) @ wd

    @staticmethod
    def backward(ctx, dy):
        g, u, wd = ctx.saved_tensors
        with torch.enable_grad():
            gg = g.detach().requires_grad_(True)
            a = _act(gg, ctx.kind)
        h = a.detach() * u
        if wd.dim() == 3:
            dwd = h.transpose(1, 2) @ dy
        else:
            dwd = h.reshape(-1, h.shape[-1]).T @ dy.reshape(-1, dy.shape[-1])
        dh = dy @ wd.transpose(-1, -2)
        dg, = torch.autograd.grad(a, gg, dh * u)
        return dg, dh * a.detach(), dwd, None


def mlp(p: Params, x: torch.Tensor, cfg: ArchConfig, par=None
        ) -> torch.Tensor:
    """The gated MLP: act(x Wg) * (x Wu), then Wd (``_GatedDown``).  With
    ``par`` (a ``common.Parallel``), Wg/Wu are column-parallel (this
    rank's d_ff columns) and Wd row-parallel: x enters the tp region and
    the partial products leave it summed."""
    if par is None:
        return _GatedDown.apply(x @ p["wg"], x @ p["wu"], p["wd"], cfg.act)
    g, u = par.column(x, p["wg"], p["wu"])
    return par.tp_out(_GatedDown.apply(g, u, p["wd"], cfg.act))


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def _no_mla(cfg: ArchConfig):
    if cfg.attention_type == "mla":
        raise NotImplementedError("MLA attention is not ported yet "
                                  "(ROADMAP.md, queue A: remaining "
                                  "families)")


def init_attention(b: ScopedBuilder, cfg: ArchConfig):
    _no_mla(cfg)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b.add("wq", (d, h, hd), ("embed", "heads", "head_dim"),
          scale=1.0 / math.sqrt(d))
    b.add("wk", (d, kv, hd), ("embed", "kv_heads", "head_dim"),
          scale=1.0 / math.sqrt(d))
    b.add("wv", (d, kv, hd), ("embed", "kv_heads", "head_dim"),
          scale=1.0 / math.sqrt(d))
    b.add("wo", (h, hd, d), ("heads", "head_dim", "embed"),
          scale=1.0 / math.sqrt(h * hd))
    if cfg.qkv_bias:
        b.add("bq", (h, hd), ("heads", "head_dim"), init="zeros")
        b.add("bk", (kv, hd), ("kv_heads", "head_dim"), init="zeros")
        b.add("bv", (kv, hd), ("kv_heads", "head_dim"), init="zeros")


def _sdpa(q, k, v, cfg: ArchConfig, mask_kind: str, kv_valid_len=None,
          acc_dtype=torch.float32) -> torch.Tensor:
    """q (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd) -> (B,Sq,KV,G,hd).  f32 softmax.

    acc_dtype: the QK^T accumulation type.  Decode passes the cache dtype:
    the product is rounded to it before the f32 softmax, as in the
    reference."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.to(acc_dtype),
                          k.to(acc_dtype)).float() * scale
    sq, sk = q.shape[1], k.shape[1]
    dev = q.device
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    if mask_kind == "causal":
        mask = (torch.arange(sq, device=dev)[:, None]
                >= torch.arange(sk, device=dev)[None, :])
        scores = torch.where(mask, scores, neg)
    if kv_valid_len is not None:
        if kv_valid_len.dim() == 1:     # (B,) -> (B, 1, 1, 1, Sk)
            kv_valid_len = kv_valid_len.view(-1, 1, 1, 1, 1)
        valid = torch.arange(sk, device=dev) < kv_valid_len
        scores = torch.where(valid, scores, neg)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)


def attention(p: Params, x: torch.Tensor, cfg: ArchConfig,
              exec_cfg: ExecConfig, *, mask_kind: str = "causal",
              cache: Optional[Dict] = None,
              return_kv: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention.  Prefill: ``cache=None``; with ``return_kv`` the second
    result is the rotated ``{"k", "v"}`` this pass computed (the serving
    cache's contents).  Decode: ``cache`` holds ``{"k","v","pos"}`` (and
    ``k_scale``/``v_scale`` when k/v are int8) with a scalar ``pos`` or a
    ``(B,)`` one, one position per row, and x is (B,1,D); the second result
    is the updated cache, whose k/v (and scales) are the input buffers
    written in place (``cache_write``).

    On a serving rank (``exec_cfg.par`` with a cache or ``return_kv``) the
    new rows are projected with the rank's whole wk, so a row is whole for
    the kv heads the cache stores, and its query heads read the ones they
    need (``_kv_range``).  Where a group splits the KV sequence only the
    rank holding ``pos`` writes the row ("onehot"), and each rank's
    partial softmax over its positions is merged over the group: over
    ``model`` (every kv head stored) for the whole tp group's query heads,
    gathered first, of which the rank keeps its own; over ``data`` (every
    data rank decodes the whole batch) for its own heads."""
    _no_mla(cfg)
    par = exec_cfg.par
    wk, wv = p["wk"], p["wv"]
    bk, bv = p.get("bk"), p.get("bv")
    kv_rows = None
    if par is not None:
        if return_kv or cache is not None:
            # serving: the cache holds every kv head wk holds (its own
            # where tp splits them, else all); attention reads the ones
            # this rank's query heads read
            kv_rows = _kv_range(p, cfg, par)
        else:
            wk, wv, bk, bv = _local_kv(p, cfg, par)
    # this rank's heads (all of them on one device)
    d = x.shape[-1]
    h, kv, hd = p["wq"].shape[1], wk.shape[1], cfg.head_dim
    g = h // kv
    ws = (p["wq"].reshape(d, h * hd), wk.reshape(d, kv * hd),
          wv.reshape(d, kv * hd))
    q, k, v = (x @ w for w in ws) if par is None else par.column(x, *ws)
    b_, s = q.shape[:2]
    q, k, v = (q.view(b_, s, h, hd), k.view(b_, s, kv, hd),
               v.view(b_, s, kv, hd))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + bk, v + bv
    if cache is not None and "pos" not in cache:
        raise NotImplementedError("cross-attention caches are not ported yet "
                                  "(ROADMAP.md, queue A: remaining families)")

    use_rope = mask_kind == "causal"
    pos = None if cache is None else cache["pos"]
    if use_rope:
        if cache is None:
            pos_q = torch.arange(s, device=x.device)[None, :]
        else:
            # a (B,) vector rotates every row by its own position
            pos_q = pos[:, None] if pos.dim() == 1 else pos.reshape(1, 1)
        cos_q, sin_q = rope_freqs(pos_q, hd, cfg.rope_theta)
        q = apply_rope(q, cos_q, sin_q)

    new_cache = None
    if cache is None:
        if use_rope:
            cos_k, sin_k = rope_freqs(torch.arange(s, device=x.device)[None, :],
                                      hd, cfg.rope_theta)
            k = apply_rope(k, cos_k, sin_k)
        if return_kv:
            new_cache = {"k": k, "v": v}
        if kv_rows is not None:
            lo, hi = kv_rows
            k, v = k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous()
            kv, g = hi - lo, h // (hi - lo)
        if exec_cfg.attn_impl != "naive":
            ctx = kops.attention(q, k, v, causal=(mask_kind == "causal"),
                                 impl=exec_cfg.attn_impl,
                                 q_block=exec_cfg.attn_q_block,
                                 kv_block=exec_cfg.attn_kv_block,
                                 kernel_impl=exec_cfg.kernel_impl)
        else:
            ctx = _sdpa(q.view(b_, s, kv, g, hd), k, v, cfg, mask_kind)
    else:  # self-attention decode: the key rotates by the query's position
        if use_rope:
            k = apply_rope(k, cos_q, sin_q)
        # a group splitting the KV sequence leaves this rank positions
        # [off, off + its length)
        split = exec_cfg.kv_split
        off = 0 if split is None else split.rank * cache["k"].shape[1]
        new_cache = {"pos": pos + 1}
        if cache["k"].dtype == torch.int8:
            # quantize the new rows, write codes and scales, and attend
            # over the whole cache dequantized to the compute dtype
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            new_cache.update(
                {n: cache_write(cache[n], u, pos, 1, exec_cfg, off) for n, u
                 in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))})
            kd = dequantize_kv(new_cache["k"], new_cache["k_scale"], x.dtype)
            vd = dequantize_kv(new_cache["v"], new_cache["v_scale"], x.dtype)
        else:
            kd = cache_write(cache["k"], k, pos, 1, exec_cfg, off)
            vd = cache_write(cache["v"], v, pos, 1, exec_cfg, off)
            new_cache.update(k=kd, v=vd)
        if split is not None and split.axis == "model":
            # every kv head stored: the partials of the whole tp group's
            # query heads, of which the rank keeps its own
            qa = all_gather_dim(q, 2, par.tp_group)
            ctx = _split_sdpa(qa.view(b_, s, kv, -1, hd).to(kd.dtype), kd,
                              vd, pos, off, split)
            ctx = ctx.reshape(b_, s, -1, hd)[:, :, par.tp_rank * h:
                                             (par.tp_rank + 1) * h]
        else:
            if kv_rows is not None:
                lo, hi = kv_rows
                kd, vd = kd[:, :, lo:hi], vd[:, :, lo:hi]
            qg = q.view(b_, s, kd.shape[2], -1, hd).to(kd.dtype)
            ctx = (_sdpa(qg, kd, vd, cfg, "full", kv_valid_len=pos + 1,
                         acc_dtype=kd.dtype) if split is None
                   else _split_sdpa(qg, kd, vd, pos, off, split))

    ctx = ctx.reshape(b_, s, h * hd)
    out = ctx @ p["wo"].reshape(h * hd, d)
    return (out if par is None else par.tp_out(out)), new_cache


def _kv_range(p: Params, cfg: ArchConfig, par
              ) -> Optional[Tuple[int, int]]:
    """The kv heads ``[lo, hi)`` of wk's that this tp rank's query heads
    read, or None where they read all of them (wk sharded with the query
    heads, or one device's heads).  Where tp does not divide the kv heads,
    wk is replicated and a rank's heads read a range of them (two ranks
    may share one)."""
    h_loc = p["wq"].shape[1]
    if p["wk"].shape[1] != cfg.num_kv_heads or h_loc == cfg.num_heads:
        return None
    g = cfg.q_per_kv
    if h_loc % g and g % h_loc:
        raise NotImplementedError(
            f"{h_loc} query heads per rank over groups of {g}: the rank's "
            "heads would read kv heads unevenly (ROADMAP.md, queue A: "
            "sharding on torch)")
    return par.tp_rank * h_loc // g, -(-(par.tp_rank + 1) * h_loc // g)


def _local_kv(p: Params, cfg: ArchConfig, par) -> Tuple[Optional[
        torch.Tensor], ...]:
    """wk/wv (and bk/bv, None without QKV biases) for this tp rank's query
    heads.  Sharded with the query heads when the kv heads divide by tp;
    otherwise replicated, and the rank takes the kv heads its query heads
    read (``_kv_range``; its gradient of the rest is zero, and the step
    sums wk/wv's and bk/bv's gradients over tp)."""
    rows = _kv_range(p, cfg, par)
    if rows is None:
        return tuple(p.get(n) for n in ("wk", "wv", "bk", "bv"))
    lo, hi = rows
    return (p["wk"][:, lo:hi], p["wv"][:, lo:hi],
            *(p[n][lo:hi] if n in p else None for n in ("bk", "bv")))


def _split_sdpa(q, k, v, pos, off: int, split) -> torch.Tensor:
    """Decode attention over a KV sequence split over ``split``'s group:
    q (B,1,KV,G,hd), k/v (B,S_loc,KV,hd) holding positions ``[off, off +
    S_loc)``; the positions at or below ``pos`` count.  Each rank's
    partial max m, sum of exponentials l and unnormalised output o per
    (row, head) are all-gathered over the group and merged in rank order
    (the same order on every rank): out = sum_r e^(m_r - M) o_r / sum_r
    e^(m_r - M) l_r with M the largest m_r.  A rank holding no valid
    position has m = NEG_INF and weighs 0.  Returns (B,1,KV,G,hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    acc = k.dtype
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.to(acc), k.to(acc)
                          ).float() * scale                  # (B,KV,G,1,S)
    sk = k.shape[1]
    valid = off + torch.arange(sk, device=q.device) < (
        pos.view(-1, 1, 1, 1, 1) if pos.dim() == 1 else pos) + 1
    scores = torch.where(valid, scores,
                         torch.full((), NEG_INF, device=q.device))
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    lsum = e.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bkgqh", e.to(v.dtype), v).float()
    b_, kvh, g = o.shape[:3]
    part = torch.cat([o.reshape(b_, -1), m.reshape(b_, -1),
                      lsum.reshape(b_, -1)], -1)
    parts = all_gather_dim(part[None], 0, split.group)      # (n, B, ...)
    n_o = o[0].numel()
    os_ = parts[..., :n_o].view((split.size,) + tuple(o.shape))
    ms = parts[..., n_o:n_o + m[0].numel()].view((split.size,)
                                                 + tuple(m.shape))
    ls = parts[..., n_o + m[0].numel():].view((split.size,)
                                              + tuple(lsum.shape))
    top = ms.amax(0)
    w = torch.exp(ms - top)                                 # (n,B,KV,G,1,1)
    out = (w * os_).sum(0) / (w * ls).sum(0)                # (B,KV,G,1,hd)
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)


def cache_write(buf: torch.Tensor, upd: torch.Tensor, pos: torch.Tensor,
                seq_dim: int, exec_cfg: ExecConfig, offset: int = 0
                ) -> torch.Tensor:
    """Write ``upd`` into the cache at ``pos`` along ``seq_dim`` IN PLACE,
    and return ``buf``.  A scalar ``pos`` is the reference's "dus"
    (dynamic-update-slice) form.  A ``(B,)`` vector writes row ``pos[b]``
    of slot ``b`` (one-token updates, ``seq_dim`` 1): the reference's
    one-hot ``where`` over the whole buffer, which its docstring holds
    bitwise to a slice write, written here by index, one row a slot.  The
    reference returns a new array; writing in place keeps one cache
    buffer for the whole generation.  ``pos`` stays a device tensor, so
    the write needs no host sync.

    ``exec_cfg.cache_update == "onehot"`` (a serving rank whose cache's
    sequence a group splits, ``training/step.py::serve_rank``): ``buf``
    holds the positions ``[offset, offset + buf.shape[seq_dim])``, and the
    rows at ``pos`` are written only where they fall in it (the rank that
    holds them); every other rank's buffer is left as it was."""
    if pos.dim() == 1:
        if seq_dim != 1 or upd.shape[1] != 1 or offset:
            raise ValueError("per-request positions write one token along "
                             "dim 1 of a whole sequence")
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, pos.long()] = upd[:, 0].to(buf.dtype)
        return buf
    idx = pos.long().reshape(1) + torch.arange(upd.shape[seq_dim],
                                               device=buf.device)
    if exec_cfg.cache_update == "dus":
        buf.index_copy_(seq_dim, idx, upd.to(buf.dtype))
        return buf
    if exec_cfg.cache_update != "onehot":
        raise ValueError(f"cache_update {exec_cfg.cache_update!r}")
    local = idx - offset
    mine = (local >= 0) & (local < buf.shape[seq_dim])
    local = local.clamp(0, buf.shape[seq_dim] - 1)
    keep = mine.view((1,) * seq_dim + (-1,) + (1,) * (buf.dim() - seq_dim - 1))
    old = buf.index_select(seq_dim, local)
    buf.index_copy_(seq_dim, local,
                    torch.where(keep, upd.to(buf.dtype), old))
    return buf


def init_self_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device="cpu") -> Dict:
    if cfg.attention_type == "mla":
        raise NotImplementedError("MLA KV caches are not ported yet")
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    out = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        # the reference's quantized layout: int8 codes and per-(token,
        # head) f32 scales (``quantize_kv``)
        out["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=device)
        out["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=device)
    return out


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., KV, hd) -> (int8 codes, f32 per-(..., KV) scales): the scale
    is the f32 max-abs over hd over 127, floored at 1e-8, and the codes
    ``round(x / scale)`` (half to even, as ``jnp.round``) clipped to
    [-127, 127]."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)
