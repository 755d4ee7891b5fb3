"""Mamba2 SSD chunk scan: the Hopper kernels, their wrapper and the plain
version (the port of ``repro/kernels/ssd_scan.py``).

The kernels (``csrc/ssd_scan.cu``) replace the Pallas TPU kernel
``_ssd_kernel``.  They take x ``(B, S, H, P)`` and B/C ``(B, S, G, N)`` in
the model's own layout, with their strides (in the model x, B and C are
strided views of the conv output, row stride ``conv_dim``), index the group
of head ``h`` as ``h // (H // G)`` instead of reading a repeated copy
(``G = H`` is the reference's layout), and return y ``(B, S, H, P)`` in x's
dtype and, unlike the TPU kernel, the final state hT ``(B, H, P, N)`` f32.

bf16 inputs (the model's) run the tensor-core kernel: one block per
(batch, head, chunk) item, the state handed from chunk to chunk through an
f32 scratch ``(B, H, nc - 1, N, P)`` and a flag per item, items taken in
chunk-major order from a ticket counter.  The wrapper allocates the scratch
with ``torch.empty`` and the counter and flags with one ``torch.zeros`` per
call.  It takes P and N in ``TC_DIMS``, any chunk whose rows fit shared
memory, and x/B/C whose bases and strides are 16-byte aligned; anything else
raises before a launch.  f32 inputs run a CUDA-core kernel (one block per
(batch, head) walking its chunks).

The plain version is the per-chunk f32 algebra of ``_ssd_kernel`` looped
over the chunks, returning ``(y, hT)``.  ``ssd_scan`` runs a kernel for a
CUDA tensor and the plain version for a CPU tensor; ``impl="plain"`` forces
the plain version on either device (a test hook).  A CUDA tensor never
falls back: a wrong dtype, an unsupported shape or a failed launch raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (the wrapper's count)
LAUNCHES = 0

# the kernels' limits: P and N up to 64, and shared memory within the
# 227 KB a block may have
MAX_HEAD_DIM = 64
SMEM_LIMIT = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# bf16 (tensor-core) kernel, mirrored from csrc/ssd_scan.cu: warps a block,
# rows of one m16n8k16 tile (the chunk is padded to it), bf16 elements of
# padding after each shared row, and the P / N it takes
TC_WARPS = 8
ROW_BLOCK = 16
SMEM_PAD = 8
TC_DIMS = (16, 32, 48, 64)
# f32 (CUDA-core) kernel: 64-row query / key tiles
_TILE = 64


def smem_bytes(q: int, p: int, n: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one block: ``tc_smem_bytes`` (bf16, the
    chunk padded to whole 16-row tiles) or ``smem_floats`` (f32) in the
    source."""
    if dtype == torch.bfloat16:
        qp = -(-q // ROW_BLOCK) * ROW_BLOCK
        return 2 * (qp * (p + SMEM_PAD) + qp * (n + SMEM_PAD)
                    + 2 * p * (n + SMEM_PAD)) + 4 * (3 * qp + TC_WARPS + 4)
    return 4 * (q * p + q * (n + 1) + _TILE * (n + 1) + _TILE * (_TILE + 1)
                + n * p + 3 * q)


def state_scratch_shape(b: int, h: int, nc: int, p: int, n: int):
    """The bf16 kernel's chain: the f32 state leaving every chunk but the
    last, ``(B, H, nc - 1, N, P)``."""
    return (b, h, nc - 1, n, p)


def sync_words(b: int, h: int, nc: int) -> int:
    """int32 zeros a bf16 call needs: the ticket counter, then one flag per
    published state."""
    return 1 + b * h * (nc - 1)


def chunk_len(chunk: int, s: int) -> int:
    """The reference's chunk: ``min(chunk, S)``, which must divide S."""
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"sequence {s} is not a multiple of chunk {q}")
    return q


def repeat_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N), each group repeated H // G times (the
    reference's ``jnp.repeat`` over groups)."""
    g = t.shape[2]
    return t if g == h else t.repeat_interleave(h // g, dim=2)


def ssd_plain(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              bb: torch.Tensor, cc: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 algebra of ``_ssd_kernel``, batched over (B, H) and looped
    over the chunks: y (B, S, H, P) in x's dtype, hT (B, H, P, N) f32."""
    bsz, s, h, p = xh.shape
    q = chunk_len(chunk, s)
    dev = xh.device
    x = xh.float().permute(0, 2, 1, 3)                       # (B,H,S,P)
    dtf = dt.float().permute(0, 2, 1)                        # (B,H,S)
    bf = repeat_groups(bb, h).float().permute(0, 2, 1, 3)   # (B,H,S,N)
    cf = repeat_groups(cc, h).float().permute(0, 2, 1, 3)
    n = bf.shape[-1]
    da = dtf * a.float()[None, :, None]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    neg_inf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    hstate = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=dev)
    ys = []
    for c0 in range(0, s, q):
        sl = slice(c0, c0 + q)
        xc, dtc, bc, ccc = x[:, :, sl], dtf[:, :, sl], bf[:, :, sl], \
            cf[:, :, sl]
        cum = torch.cumsum(da[:, :, sl], dim=-1)             # (B,H,Q)
        rel = cum[..., :, None] - cum[..., None, :]          # (B,H,Qt,Qs)
        # mask BEFORE exp: above the diagonal rel > 0 can overflow
        lmat = torch.exp(torch.where(tri, rel, neg_inf))
        scores = (ccc @ bc.transpose(-1, -2)) * lmat * dtc[..., None, :]
        y = scores @ xc
        y = y + (ccc * torch.exp(cum)[..., None]) @ hstate
        w = torch.exp(cum[..., -1:] - cum) * dtc             # (B,H,Q)
        new_state = (bc * w[..., None]).transpose(-1, -2) @ xc
        hstate = hstate * torch.exp(cum[..., -1])[..., None, None] + new_state
        ys.append(y)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(xh.dtype)
    return y, hstate.transpose(-1, -2)


def _check_cuda_inputs(xh, dt, a, bb, cc):
    for name, t in (("dt", dt), ("a", a), ("bb", bb), ("cc", cc)):
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, xh on {xh.device}")
    if xh.dtype not in _DTYPE_CODES or bb.dtype != xh.dtype or \
            cc.dtype != xh.dtype:
        raise TypeError(f"ssd kernel takes bf16 or f32 xh/bb/cc of one "
                        f"dtype; got {xh.dtype}, {bb.dtype}, {cc.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd kernel takes f32 dt and a; got {dt.dtype}, "
                        f"{a.dtype}")
    bsz, s, h, p = xh.shape
    if bb.dim() != 4 or bb.shape != cc.shape or bb.shape[:2] != (bsz, s) \
            or h % bb.shape[2] or dt.shape != (bsz, s, h) or \
            a.shape != (h,):
        raise ValueError(f"shapes xh {tuple(xh.shape)} dt {tuple(dt.shape)} "
                         f"a {tuple(a.shape)} bb {tuple(bb.shape)} "
                         f"cc {tuple(cc.shape)}")
    for name, t in (("xh", xh), ("bb", bb), ("cc", cc)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim "
                             f"(strides {t.stride()})")
    n = bb.shape[3]
    if p > MAX_HEAD_DIM or n > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {p} / state {n}: the kernel takes up to "
                         f"{MAX_HEAD_DIM}")


def _check_tc_route(xh, bb, cc, q):
    """The bf16 kernel's limits: P and N in TC_DIMS, the chunk's rows within
    shared memory, and 16-byte aligned bases and strides (cp.async)."""
    p, n = xh.shape[3], bb.shape[3]
    if p not in TC_DIMS or n not in TC_DIMS:
        raise ValueError(f"head_dim {p} / state {n}: the bf16 kernel takes "
                         f"{TC_DIMS}")
    if smem_bytes(q, p, n) > SMEM_LIMIT:
        raise ValueError(f"chunk {q} at P {p}, N {n} needs "
                         f"{smem_bytes(q, p, n)} B of shared memory; a "
                         f"block may have {SMEM_LIMIT}")
    for name, t in (("xh", xh), ("bb", bb), ("cc", cc)):
        used = [t.stride(d) for d in range(3) if t.shape[d] > 1]
        if t.data_ptr() % 16 or any(st % 8 for st in used):
            raise ValueError(f"{name} must start on 16 bytes and have strides "
                             f"of whole 16-byte vectors for the bf16 kernel "
                             f"(offset {t.data_ptr() % 16}, strides "
                             f"{t.stride()})")


def _launch(xh, dt, a, bb, cc, q):
    global LAUNCHES
    _check_cuda_inputs(xh, dt, a, bb, cc)
    bsz, s, h, p = xh.shape
    g, n = bb.shape[2], bb.shape[3]
    nc = s // q
    if xh.dtype == torch.bfloat16:
        _check_tc_route(xh, bb, cc, q)
    elif smem_bytes(q, p, n, xh.dtype) > SMEM_LIMIT:
        raise ValueError(f"chunk {q} at P {p}, N {n} needs "
                         f"{smem_bytes(q, p, n, xh.dtype)} B of shared "
                         f"memory; a block may have {SMEM_LIMIT}")
    a = a.contiguous()
    y = torch.empty((bsz, s, h, p), dtype=xh.dtype, device=xh.device)
    hT = torch.empty((bsz, h, p, n), dtype=torch.float32, device=xh.device)
    if xh.numel() == 0:
        return y, hT.zero_()
    states = sync = None
    if xh.dtype == torch.bfloat16:
        states = torch.empty(state_scratch_shape(bsz, h, nc, p, n),
                             dtype=torch.float32, device=xh.device)
        sync = torch.zeros(sync_words(bsz, h, nc), dtype=torch.int32,
                           device=xh.device)
    lib = _build.load_library()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = lib.mist_ssd_scan(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), bb.data_ptr(),
            cc.data_ptr(), y.data_ptr(), hT.data_ptr(),
            states.data_ptr() if states is not None else None,
            sync.data_ptr() if sync is not None else None,
            bsz, s, h, g, p, n, q, _DTYPE_CODES[xh.dtype],
            *xh.stride()[:3], *dt.stride(), *bb.stride()[:3],
            *cc.stride()[:3], stream)
    _build.check(err, "ssd scan kernel")
    LAUNCHES += 1
    return y, hT


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bb: torch.Tensor, cc: torch.Tensor, *, chunk: int = 256,
             impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """xh (B,S,H,P); dt (B,S,H) f32; a (H,) f32; bb/cc (B,S,G,N) with G
    dividing H -> (y (B,S,H,P) in xh's dtype, hT (B,H,P,N) f32).

    ``impl="kernel"``: the Hopper kernel for CUDA tensors, the plain version
    for CPU tensors.  ``impl="plain"``: the plain version.
    """
    q = chunk_len(chunk, xh.shape[1])
    if impl == "plain" or (impl == "kernel" and xh.device.type == "cpu"):
        return ssd_plain(xh, dt, a, bb, cc, q)
    if impl != "kernel":
        raise ValueError(f"impl {impl!r}: 'kernel' or 'plain'")
    if xh.device.type != "cuda":
        raise ValueError(f"no kernel for device {xh.device}")
    return _launch(xh, dt, a, bb, cc, q)
