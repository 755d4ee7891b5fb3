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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ExecConfig, Params, ScopedBuilder

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
    written in place (``cache_write``)."""
    _no_mla(cfg)
    par = exec_cfg.par
    wk, wv = p["wk"], p["wv"]
    bk, bv = p.get("bk"), p.get("bv")
    if par is not None:
        if cache is not None:
            raise NotImplementedError("multi-device decode waits for "
                                      "multi-device serving (ROADMAP.md, "
                                      "queue A: serving)")
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
        if exec_cfg.attn_impl != "naive":
            ctx = kops.attention(q, k, v, causal=(mask_kind == "causal"),
                                 impl=exec_cfg.attn_impl,
                                 q_block=exec_cfg.attn_q_block,
                                 kv_block=exec_cfg.attn_kv_block,
                                 kernel_impl=exec_cfg.kernel_impl)
        else:
            ctx = _sdpa(q.view(b_, s, kv, g, hd), k, v, cfg, mask_kind)
        if return_kv:
            new_cache = {"k": k, "v": v}
    else:  # self-attention decode: the key rotates by the query's position
        if use_rope:
            k = apply_rope(k, cos_q, sin_q)
        new_cache = {"pos": pos + 1}
        if cache["k"].dtype == torch.int8:
            # quantize the new rows, write codes and scales, and attend
            # over the whole cache dequantized to the compute dtype
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            new_cache.update(
                {n: cache_write(cache[n], u, pos, 1, exec_cfg) for n, u in
                 (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))})
            kd = dequantize_kv(new_cache["k"], new_cache["k_scale"], x.dtype)
            vd = dequantize_kv(new_cache["v"], new_cache["v_scale"], x.dtype)
        else:
            kd = cache_write(cache["k"], k, pos, 1, exec_cfg)
            vd = cache_write(cache["v"], v, pos, 1, exec_cfg)
            new_cache.update(k=kd, v=vd)
        qg = q.view(b_, s, kv, g, hd).to(kd.dtype)
        ctx = _sdpa(qg, kd, vd, cfg, "full", kv_valid_len=pos + 1,
                    acc_dtype=kd.dtype)

    ctx = ctx.reshape(b_, s, h * hd)
    out = ctx @ p["wo"].reshape(h * hd, d)
    return (out if par is None else par.tp_out(out)), new_cache


def _local_kv(p: Params, cfg: ArchConfig, par) -> Tuple[Optional[
        torch.Tensor], ...]:
    """wk/wv (and bk/bv, None without QKV biases) for this tp rank's query
    heads.  Sharded with the query heads when the kv heads divide by tp;
    otherwise replicated, and the rank takes the kv heads its query heads
    read (its gradient of the rest is zero, and the step sums wk/wv's and
    bk/bv's gradients over tp)."""
    h_loc = p["wq"].shape[1]
    if p["wk"].shape[1] != cfg.num_kv_heads or h_loc == cfg.num_heads:
        return tuple(p.get(n) for n in ("wk", "wv", "bk", "bv"))
    g = cfg.q_per_kv
    if h_loc % g and g % h_loc:
        raise NotImplementedError(
            f"{h_loc} query heads per rank over groups of {g}: the rank's "
            "heads would read kv heads unevenly (ROADMAP.md, queue A: "
            "sharding on torch)")
    lo = par.tp_rank * h_loc // g
    hi = -(-(par.tp_rank + 1) * h_loc // g)
    return (p["wk"][:, lo:hi], p["wv"][:, lo:hi],
            *(p[n][lo:hi] if n in p else None for n in ("bk", "bv")))


def cache_write(buf: torch.Tensor, upd: torch.Tensor, pos: torch.Tensor,
                seq_dim: int, exec_cfg: ExecConfig) -> torch.Tensor:
    """Write ``upd`` into the cache at ``pos`` along ``seq_dim`` IN PLACE,
    and return ``buf``.  A scalar ``pos`` is the reference's "dus"
    (dynamic-update-slice) form.  A ``(B,)`` vector writes row ``pos[b]``
    of slot ``b`` (one-token updates, ``seq_dim`` 1): the reference's
    one-hot ``where`` over the whole buffer, which its docstring holds
    bitwise to a slice write, written here by index, one row a slot.  The
    reference returns a new array; writing in place keeps one cache
    buffer for the whole generation.  ``pos`` stays a device tensor, so
    the write needs no host sync."""
    if pos.dim() == 1:
        if seq_dim != 1 or upd.shape[1] != 1:
            raise ValueError("per-request positions write one token along "
                             "dim 1")
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, pos.long()] = upd[:, 0].to(buf.dtype)
        return buf
    if exec_cfg.cache_update != "dus":
        raise NotImplementedError(f"cache_update {exec_cfg.cache_update!r} "
                                  "waits for the multi-device slice")
    idx = pos.long().reshape(1) + torch.arange(upd.shape[seq_dim],
                                               device=buf.device)
    buf.index_copy_(seq_dim, idx, upd.to(buf.dtype))
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
