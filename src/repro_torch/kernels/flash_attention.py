"""Flash attention, forward and backward: the Hopper kernels, their wrappers,
their plain versions and the autograd Function over both (the port of
``repro/kernels/flash_attention.py`` and of the custom VJP in
``repro/kernels/ops.py``).

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``_fa_kernel``.  It takes q/k/v in the model's own layout -- q
``(B, Sq, H, hd)``, k/v ``(B, Sk, KV, hd)`` with their strides -- indexes
the KV head of query head ``h`` as ``h // (H // KV)`` instead of
broadcasting it, and returns ``o (B, Sq, H, hd)`` and the log-sum-exp
``lse (B, H, Sq)`` in f32.

The plain version is the blocked online-softmax forward of
``ops._blocked_fwd`` (one f32 ``(acc, m, l)`` carry over KV blocks), which
also returns ``lse``.  ``flash_attention`` runs the kernel for a CUDA
tensor and the plain version for a CPU tensor; ``impl="plain"`` forces the
plain version on either device (a test hook for comparing the two on the
card).  A CUDA tensor never falls back: a wrong dtype, an unsupported shape
or a failed launch raises.

The backward kernel (``csrc/flash_attention_bwd.cu``) replaces the
reference's gradient, ``jax.custom_vjp`` around the Pallas forward with the
blocked jnp backward ``ops._blocked_bwd``.  It takes q/k/v, o, dO and lse in
the same layouts and returns dq ``(B, Sq, H, hd)`` and dk/dv
``(B, Sk, KV, hd)`` in bf16, summing the GQA group's contributions to one
KV head in f32, and dq over the key tiles in f32 in ascending key-tile
order (a scratch buffer the wrapper allocates, ``bwd_scratch_elems``).  Its plain version is ``blocked_bwd``, a line-for-line port
of ``_blocked_bwd``.  ``FlashAttention`` is the autograd Function: its
forward runs ``flash_attention`` and saves q, k, v, o and lse, its
backward runs ``flash_attention_bwd``; under ``torch.inference_mode`` it is
the forward alone.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, tiles
from repro_torch.kernels.ref import NEG_INF

# launches of the CUDA kernels in this process (the wrappers' counts): the
# forward, and the backward (one per call of its wrapper)
LAUNCHES = 0
BWD_LAUNCHES = 0

HEAD_DIMS = tiles.FLASH_HEAD_DIMS

# the kernel's launch shape (csrc/flash_attention.cu): query rows per work
# item, keys per K/V tile at the plan's default (the tile menu,
# ``tiles.MENU``, also has 64), the tiles of each kind in shared memory (Q
# double buffered, K and V rings), and the shared memory a block may have on
# an H100
BLOCK_M = tiles.FWD_BLOCK_M
BLOCK_N = tiles.HOPPER_DEFAULT["attn_kv_block"]
Q_STAGES, K_STAGES, V_STAGES = (tiles.FWD_Q_STAGES, tiles.FWD_K_STAGES,
                                tiles.FWD_V_STAGES)
SMEM_LIMIT = tiles.SMEM_LIMIT
# blocks per SM the design counts on: a persistent grid of one block per SM
# (registers for two warpgroups' S, O and P fragments admit no more)
RESIDENT_BLOCKS = 1


# the backward kernel's launch shape (csrc/flash_attention_bwd.cu): keys per
# block at the plan's default (64 per consumer warpgroup; the menu also has
# blocks of 64 keys, one warpgroup), query rows per tile, and the stages of
# the q/dO ring, of the dS^T tiles and of the f32 dQ parts in shared memory
BWD_BLOCK_N = tiles.HOPPER_DEFAULT["attn_kv_block"]
BWD_BLOCK_M = tiles.BWD_BLOCK_M
BWD_Q_STAGES, BWD_DS_STAGES, BWD_DQ_STAGES = (
    tiles.BWD_Q_STAGES, tiles.BWD_DS_STAGES, tiles.BWD_DQ_STAGES)


def _check_tile(hd: int, block_n: int) -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    if block_n not in tiles.MENU["attn_kv_block"]:
        raise ValueError(f"{block_n} keys a tile: the kernels take "
                         f"{tiles.MENU['attn_kv_block']}")


def bwd_smem_bytes(hd: int, block_n: int = BWD_BLOCK_N) -> int:
    """Dynamic shared memory of one backward block of ``block_n`` keys
    (``smem_bytes`` in ``flash_attention_bwd.cu``, ``tiles.flash_bwd_smem``):
    K and V tiles, the q/dO ring, the dS^T tiles, the f32 dQ parts, the
    lse/delta rows of each stage, 9 mbarriers and the ticket."""
    _check_tile(hd, block_n)
    return tiles.flash_bwd_smem(hd, block_n)


def bwd_scratch_elems(b: int, sq: int, h: int, hd: int) -> int:
    """4-byte elements of the backward's scratch (``carve`` in the source):
    dq_accum f32 (B, Sq, H, hd); lse * log2(e) and delta f32 (B, H, SqP)
    with SqP = Sq padded to whole query tiles; the ticket and one counter
    per (batch, head, query tile), int32."""
    sqp = -(-sq // BWD_BLOCK_M) * BWD_BLOCK_M
    return b * sq * h * hd + 2 * b * h * sqp + 1 + b * h * sqp // BWD_BLOCK_M


def smem_bytes(hd: int, block_n: int = BLOCK_N) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the source,
    ``tiles.flash_fwd_smem``): the bf16 Q tiles of 128 rows, the K and V
    tiles of ``block_n`` rows and two 8-byte mbarriers (full, empty) per
    tile.  Raises for a head dim or a tile the kernel lacks."""
    _check_tile(hd, block_n)
    return tiles.flash_fwd_smem(hd, block_n)


def fit_block(blk: int, size: int) -> int:
    """The reference's block fitting (``ops._fit_block``): halve until the
    block divides ``size``.  Only the plain version tiles this way; the
    kernel masks ragged edges itself."""
    blk = min(blk, size)
    while size % blk:
        blk //= 2
    return blk


def blocked_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, scale: float, block: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/v (BH, S, D) -> out (BH, Sq, D), lse (BH, Sq) f32: online softmax
    over KV blocks of ``block`` rows (``block`` divides Sk)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    assert sk % block == 0, (sk, block)
    dev = q.device
    qf = q.float()
    qpos = torch.arange(sq, device=dev)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((bh, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    for ki in range(sk // block):
        kc = k[:, ki * block:(ki + 1) * block]
        vc = v[:, ki * block:(ki + 1) * block]
        # f32 accumulation of QK^T (preferred_element_type=f32)
        s = torch.einsum("bqd,bkd->bqk", qf, kc.float()) * scale
        if causal:
            kpos = ki * block + torch.arange(block, device=dev)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqk,bkd->bqd", p.to(v.dtype), vc).float()
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def blocked_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                causal: bool, scale: float, block: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/k/v/out/dout (BH, S, D), lse (BH, Sq) f32 -> dq, dk, dv in the
    input dtypes (``ops._blocked_bwd``, with its roundings): P goes to
    dout's dtype before P^T dO, dS to q's dtype before dS K and dS^T q, and
    dq sums in f32 across KV blocks of ``block`` rows (``block`` divides
    Sk)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    assert sk % block == 0, (sk, block)
    dev = q.device
    delta = (dout.float() * out.float()).sum(-1)
    qf, dof = q.float(), dout.float()
    qpos = torch.arange(sq, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    dq = torch.zeros((bh, sq, d), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for ki in range(sk // block):
        kc = k[:, ki * block:(ki + 1) * block]
        vc = v[:, ki * block:(ki + 1) * block]
        s = torch.einsum("bqd,bkd->bqk", qf, kc.float()) * scale
        if causal:
            kpos = ki * block + torch.arange(block, device=dev)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, neg)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bqk,bqd->bkd", p.to(dout.dtype), dout))
        dp = torch.einsum("bqd,bkd->bqk", dof, vc.float())
        ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
        dq = dq + torch.einsum("bqk,bkd->bqd", ds, kc).float()
        dks.append(torch.einsum("bqk,bqd->bkd", ds, q))
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


def _heads_first(x, g):
    """(B, S, KV, hd) -> (B*KV*g, S, hd), each KV head repeated over its
    group of g query heads (g = 1: (B, S, H, hd) -> (B*H, S, hd))."""
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, g, hd) \
        .permute(0, 2, 3, 1, 4).reshape(b * kv * g, s, hd)


def _plain(q, k, v, causal, scale, kv_block):
    """GQA broadcast to (B*H, S, hd) as ops.attention does, blocked_fwd, and
    back to the kernel's output layouts."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    of, lse = blocked_fwd(_heads_first(q, 1), _heads_first(k, g),
                          _heads_first(v, g), causal, scale,
                          fit_block(kv_block, sk))
    o = of.reshape(b, h, sq, hd).transpose(1, 2).contiguous()
    return o, lse.reshape(b, h, sq)


def _plain_bwd(q, k, v, o, lse, dout, causal, scale, kv_block):
    """blocked_bwd on the GQA broadcast, as the reference differentiates
    ops.attention; dk/dv sum over each KV head's group in f32."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    dqf, dkf, dvf = blocked_bwd(
        _heads_first(q, 1), _heads_first(k, g), _heads_first(v, g),
        _heads_first(o, 1), lse.reshape(b * h, sq), _heads_first(dout, 1),
        causal, scale, fit_block(kv_block, sk))

    def group_sum(x, dtype):
        return x.float().reshape(b, kv, g, sk, hd).sum(2) \
            .transpose(1, 2).to(dtype).contiguous()

    dq = dqf.reshape(b, h, sq, hd).transpose(1, 2).contiguous()
    return dq, group_sum(dkf, k.dtype), group_sum(dvf, v.dtype)


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernels (a CUDA tensor)."""
    return t.device.type == "cuda"


def _check_cuda_inputs(q, k, v):
    # the head dim first: the kernel is instantiated for HEAD_DIMS only
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in the kernel's "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel takes bf16; {name} is "
                            f"{t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-d with a contiguous head dim")
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned for the "
                             f"kernel's vector loads (strides {t.stride()})")
    b, sq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads over {k.shape[2]} KV heads")


def _launch(q, k, v, causal, scale, block_n=BLOCK_N):
    global LAUNCHES
    _check_cuda_inputs(q, k, v)
    _check_tile(q.shape[-1], block_n)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mist_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, kv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(causal), int(block_n), stream)
    _build.check(err, "flash attention kernel")
    LAUNCHES += 1
    return o, lse


def _launch_bwd(q, k, v, o, lse, dout, causal, scale, block_n=BWD_BLOCK_N):
    global BWD_LAUNCHES
    _check_cuda_inputs(q, k, v)
    _check_tile(q.shape[-1], block_n)
    q, k, v, o, dout = (t.contiguous() for t in (q, k, v, o, dout))
    for name, t in (("o", o), ("dout", dout)):
        if t.dtype != torch.bfloat16 or t.shape != q.shape \
                or t.device != q.device:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} for q {tuple(q.shape)}")
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq):
        raise ValueError(f"lse {lse.dtype} {tuple(lse.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("dout", dout)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scratch = torch.empty(bwd_scratch_elems(b, sq, h, hd),
                          dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mist_flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kv, hd,
            float(scale), int(causal), int(block_n), stream)
    _build.check(err, "flash attention backward kernel")
    BWD_LAUNCHES += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        scale: Optional[float] = None, q_block: int = 512,
                        kv_block: int = 512, impl: str = "kernel"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention``: q/o/dout (B, Sq, H, hd), k/v
    (B, Sk, KV, hd), lse (B, H, Sq) f32 -> dq, dk, dv in q/k/v's layouts and
    dtypes.  ``impl`` and the tiles as in ``flash_attention``: the kernel's
    blocks own ``kv_block``'s Hopper tile of keys."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if impl == "plain" or (impl == "kernel" and q.device.type == "cpu"
                           and not _on_card(q)):
        return _plain_bwd(q, k, v, o, lse, dout, causal, scale, kv_block)
    if impl != "kernel":
        raise ValueError(f"impl {impl!r}: 'kernel' or 'plain'")
    if not _on_card(q):
        raise ValueError(f"no kernel for device {q.device}")
    tiles.hopper_tile("attn_q_block", q_block)
    return _launch_bwd(q, k, v, o, lse, dout, causal, scale,
                       tiles.hopper_tile("attn_kv_block", kv_block))


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with the gradient of the reference's custom
    VJP: the forward saves q, k, v, o and the log-sum-exp, and the backward
    recomputes P from them (``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float],
                q_block: int, kv_block: int, impl: str):
        o, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                 q_block=q_block, kv_block=kv_block,
                                 impl=impl)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, scale=scale, q_block=q_block,
                        kv_block=kv_block, impl=impl)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, dout.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_block: int = 512, kv_block: int = 512,
                    impl: str = "kernel"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> o (B, Sq, H, hd),
    lse (B, H, Sq) f32.

    ``impl="kernel"``: the Hopper kernel for CUDA tensors (bf16 only), the
    plain version for CPU tensors.  ``impl="plain"``: the plain version.
    ``q_block``/``kv_block`` are the plan's tiles: the plain version tiles
    KV by ``kv_block`` as the reference does; the kernel runs their Hopper
    tiles (``tiles.hopper_tile``: 128 query rows an item, and K/V tiles of
    128 keys at the default, or of 64), and a tile that is neither the
    default nor a menu entry raises before the launch.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if impl == "plain" or (impl == "kernel" and q.device.type == "cpu"
                           and not _on_card(q)):
        return _plain(q, k, v, causal, scale, kv_block)
    if impl != "kernel":
        raise ValueError(f"impl {impl!r}: 'kernel' or 'plain'")
    if not _on_card(q):
        raise ValueError(f"no kernel for device {q.device}")
    tiles.hopper_tile("attn_q_block", q_block)
    return _launch(q, k, v, causal, scale,
                   tiles.hopper_tile("attn_kv_block", kv_block))
