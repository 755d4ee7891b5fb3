"""Mamba2 SSD chunk scan: the Hopper kernels, their wrappers, their autograd
Function and the plain versions (the port of ``repro/kernels/ssd_scan.py``).

The kernels (``csrc/ssd_scan.cu``) replace the Pallas TPU kernel
``_ssd_kernel``.  They take x ``(B, S, H, P)`` and B/C ``(B, S, G, N)`` in
the model's own layout, with their strides (in the model x, B and C are
strided views of the conv output, row stride ``conv_dim``), index the group
of head ``h`` as ``h // (H // G)`` instead of reading a repeated copy
(``G = H`` is the reference's layout), and return y ``(B, S, H, P)`` in x's
dtype and, unlike the TPU kernel, the final state hT ``(B, H, P, N)`` f32.

bf16 inputs (the model's) run the tensor-core kernel: one block per
(batch, head, chunk) item, the state handed from chunk to chunk through an
f32 scratch and a flag per item, items taken in chunk-major order from a
ticket counter.  The wrapper allocates the scratch (chunk-major, ``(nc - 1,
B, H, N, P)``: the state entering every chunk but the first) with
``torch.empty`` and the counter and flags with one ``torch.zeros`` per call.
It takes P and N in ``TC_DIMS``, any chunk whose rows fit shared memory, and
x/B/C whose bases and strides are 16-byte aligned; anything else raises
before a launch.  f32 inputs run a CUDA-core kernel (one block per
(batch, head) walking its chunks), which writes the same scratch of
entering states.

The backward (``csrc/ssd_scan_bwd.cu``) replaces no TPU kernel: the
reference differentiates only its jnp ``ssd_chunked`` (its Pallas route has
no VJP).  It takes dy and the forward's entering states and returns dx in
x's dtype, dB and dC ``(B, S, G, N)`` in their own dtype (summed over the
heads of each group in a fixed order), ddt ``(B, S, H)`` and da ``(H,)`` in
f32; two calls give the same bits.  bf16 inputs run its tensor-core kernel:
one block of 16 warps per (batch, head, chunk) item, clusters of up to 8
heads of a group at one (batch, chunk) that sum their dB and dC through
distributed shared memory, one f32 part per cluster left for a second
kernel (``bwd_parts_shape``); it takes P and N in ``TC_DIMS``, chunks up to
``BWD_MAX_CHUNK`` and 16-byte aligned x/B/C/dy, and anything else raises
before a launch.  f32 inputs run the CUDA-core kernel, one part per head.
``SSDScan`` is the autograd Function over the two; on a CUDA tensor the
forward wrapper refuses inputs that require grad unless the call comes
through it (a kernel result has no ``grad_fn``, so every gradient upstream
would be lost without an error).

The plain versions are the per-chunk f32 algebra of ``_ssd_kernel`` looped
over the chunks, returning ``(y, hT)`` (``ssd_plain``), and its gradient,
the same chunks walked back to front (``ssd_bwd_plain``).  ``ssd_scan``
runs a kernel for a CUDA tensor and the plain version for a CPU tensor;
``impl="plain"`` forces the plain version on either device (a test hook).
A CUDA tensor never falls back: a wrong dtype, an unsupported shape or a
failed launch raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, tiles

# launches of the CUDA kernels in this process (the wrappers' counts)
LAUNCHES = 0
BWD_LAUNCHES = 0

# the kernels' limits: P and N up to 64, and shared memory within the
# 227 KB a block may have
MAX_HEAD_DIM = 64
SMEM_LIMIT = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# bf16 (tensor-core) kernel, mirrored from csrc/ssd_scan.cu: warps a block,
# rows of one m16n8k16 tile (the chunk is padded to it), bf16 elements of
# padding after each shared row, and the P / N it takes
TC_WARPS = tiles.SSD_TC_WARPS
ROW_BLOCK = tiles.SSD_ROW_BLOCK
SMEM_PAD = tiles.SSD_SMEM_PAD
TC_DIMS = tiles.SSD_TC_DIMS
# f32 (CUDA-core) kernel: 64-row query / key tiles
_TILE = 64


def smem_bytes(q: int, p: int, n: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one block: ``tc_smem_bytes`` (bf16, the
    chunk padded to whole 16-row tiles) or ``smem_floats`` (f32) in the
    source."""
    if dtype == torch.bfloat16:
        return int(tiles.ssd_fwd_smem(q, p, n))
    return 4 * (q * p + q * (n + 1) + _TILE * (n + 1) + _TILE * (_TILE + 1)
                + n * p + 3 * q)


# the backward kernels (csrc/ssd_scan_bwd.cu).  bf16 (tensor cores): warps
# a block, one 16-row block each (so the longest chunk), bf16 padding after
# each shared row, f32 padding after each staged dB / dC row, and the most
# heads a cluster.  f32 (CUDA cores): threads a block (16 x 16) and rows of
# its square tiles; one f32 of padding after each shared row.
BWD_TC_WARPS = tiles.SSD_BWD_TC_WARPS
BWD_MAX_CHUNK = tiles.SSD_BWD_MAX_CHUNK
BWD_STAGE_PAD = tiles.SSD_BWD_STAGE_PAD
BWD_MAX_CLUSTER = 8
BWD_THREADS = 256
BWD_TILE = 64


def bwd_smem_bytes(q: int, p: int, n: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one backward block (``tc_smem_bytes`` /
    ``f32_smem_bytes`` in the source).  bf16: x, dy (Qp x P+8) and B, C
    (Qp x N+8) of the chunk padded to whole 16-row blocks -- a region the
    f32 dB / dC staging (2 x Qp x N+4) reuses after both passes -- dH and
    H_in as bf16 hi and lo (4 x N x P+8), nine f32 vectors over the rows,
    the warps' sums, two scalars and the ticket.  f32: x, dy, B and C (rows
    padded to whole 64-row tiles, one f32 after each row), nine f32
    vectors, two 64 x 65 tiles, two 16 x 64 partial-sum tiles, the entering
    state and its gradient (N x P+1 each), and the block's scratch."""
    if dtype == torch.bfloat16:
        return int(tiles.ssd_bwd_smem(q, p, n))
    qp = -(-q // BWD_TILE) * BWD_TILE
    return 4 * (2 * qp * (p + 1 + n + 1) + 9 * qp
                + 2 * BWD_TILE * (BWD_TILE + 1) + 2 * 16 * BWD_TILE
                + 2 * n * (p + 1) + 16)


def bwd_cluster(h: int, g: int, dtype=torch.bfloat16) -> int:
    """Heads a cluster of the backward takes (``tc_cluster``): bf16, the
    most heads of one group up to ``BWD_MAX_CLUSTER``, a power of 2; f32,
    one."""
    if dtype != torch.bfloat16:
        return 1
    cl = BWD_MAX_CLUSTER
    while (h // g) % cl:
        cl //= 2
    return cl


def bwd_parts_shape(b: int, s: int, h: int, g: int, n: int,
                    dtype=torch.bfloat16):
    """The backward's f32 parts of dB and dC that its second kernel sums:
    one per cluster of heads, ``(2, B, S, H / cluster, N)``."""
    return (2, b, s, h // bwd_cluster(h, g, dtype), n)


def state_scratch_shape(b: int, h: int, nc: int, p: int, n: int):
    """The forward kernels' chain: the f32 state leaving every chunk but the
    last (entering every chunk but the first), chunk-major, ``(nc - 1, B,
    H, N, P)``; the backward reads it, and hands dH along the chunks
    through a scratch of the same shape."""
    return (nc - 1, b, h, n, p)


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


def ssd_bwd_plain(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  bb: torch.Tensor, cc: torch.Tensor, dy: torch.Tensor,
                  chunk: int) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_plain``'s y, in f32, batched over (B, H) and
    looped over the chunks back to front: ``(dx, ddt, da, dbb, dcc)`` with
    dx in x's dtype, dbb/dcc ``(B, S, G, N)`` in their own dtype (summed
    over the heads of each group), ddt ``(B, S, H)`` and da ``(H,)`` f32.

    Per chunk, with cum the in-chunk cumsum of dt a, L_ts = exp(cum_t -
    cum_s) for s <= t (masked BEFORE the exp), G = C B^T, dS = dy x^T,
    H_in the state entering the chunk and dH the gradient of the state
    leaving it:
      dx_s  = sum_t G L dt_s dy_t + e_s dt_s (B_s dH)
                (e_s = exp(cum_Q - cum_s))
      dB_s  = sum_t dS L dt_s C_t + e_s dt_s (dH x_s)
      dC_t  = sum_s dS L dt_s B_s + exp(cum_t) (H_in dy_t)
      ddt_s = sum_t dS G L + e_s B_s.(dH x_s) + a dda_s
      dH_in = exp(cum_Q) dH + sum_t exp(cum_t) C_t dy_t^T
    where dda is the reverse cumsum of the gradient of cum, and da sums
    dt dda over every (batch, position)."""
    bsz, s, h, p = xh.shape
    g = bb.shape[2]
    q = chunk_len(chunk, s)
    dev = xh.device
    x = xh.float().permute(0, 2, 1, 3)                       # (B,H,S,P)
    dyf = dy.float().permute(0, 2, 1, 3)
    dtf = dt.float().permute(0, 2, 1)                        # (B,H,S)
    bf = repeat_groups(bb, h).float().permute(0, 2, 1, 3)   # (B,H,S,N)
    cf = repeat_groups(cc, h).float().permute(0, 2, 1, 3)
    n = bf.shape[-1]
    af = a.float()[None, :, None]
    da_all = dtf * af
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    neg_inf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    chunks = [slice(c0, c0 + q) for c0 in range(0, s, q)]
    # the forward's states: the one entering each chunk, (B,H,N,P)
    hstate = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=dev)
    entering = []
    for sl in chunks:
        entering.append(hstate)
        cum = torch.cumsum(da_all[:, :, sl], dim=-1)
        w = torch.exp(cum[..., -1:] - cum) * dtf[:, :, sl]
        hstate = hstate * torch.exp(cum[..., -1])[..., None, None] + \
            (bf[:, :, sl] * w[..., None]).transpose(-1, -2) @ x[:, :, sl]
    dx, dbf, dcf = torch.empty_like(x), torch.empty_like(bf), \
        torch.empty_like(cf)
    ddt = torch.empty_like(dtf)
    da = torch.zeros((bsz, h), dtype=torch.float32, device=dev)
    dstate = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=dev)
    for sl, h_in in zip(reversed(chunks), reversed(entering)):
        xc, dyc, dtc = x[:, :, sl], dyf[:, :, sl], dtf[:, :, sl]
        bc, ccc = bf[:, :, sl], cf[:, :, sl]
        cum = torch.cumsum(da_all[:, :, sl], dim=-1)         # (B,H,Q)
        rel = cum[..., :, None] - cum[..., None, :]          # (B,H,Qt,Qs)
        lmat = torch.exp(torch.where(tri, rel, neg_inf))
        gmat = ccc @ bc.transpose(-1, -2)                    # C_t . B_s
        dsm = dyc @ xc.transpose(-1, -2)                     # dy_t . x_s
        smat = gmat * lmat * dtc[..., None, :]               # the scores
        wmat = dsm * lmat * dtc[..., None, :]
        e_out = torch.exp(cum[..., -1:] - cum)               # (B,H,Q)
        e_in = torch.exp(cum)
        xdh = xc @ dstate.transpose(-1, -2)                  # (B,H,Q,N)
        dci = e_in[..., None] * (dyc @ h_in.transpose(-1, -2))
        dx[:, :, sl] = smat.transpose(-1, -2) @ dyc + \
            (e_out * dtc)[..., None] * (bc @ dstate)
        dbf[:, :, sl] = wmat.transpose(-1, -2) @ ccc + \
            (e_out * dtc)[..., None] * xdh
        dcf[:, :, sl] = wmat @ bc + dci
        v = (bc * xdh).sum(-1)                               # B_s . dH x_s
        u = e_out * dtc * v
        # M_tt would add to both sums and cancel: left out of both
        m = (dsm * smat).tril(-1)
        dcum = m.sum(-1) - m.sum(-2) + (ccc * dci).sum(-1) - u
        dcum[..., -1] += u.sum(-1) + torch.exp(cum[..., -1]) * \
            (h_in * dstate).sum((-1, -2))
        dda = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
        ddt[:, :, sl] = (dsm * gmat * lmat).sum(-2) + e_out * v + af * dda
        da += (dtc * dda).sum(-1)
        dstate = dstate * torch.exp(cum[..., -1])[..., None, None] + \
            (ccc * e_in[..., None]).transpose(-1, -2) @ dyc

    def per_group(t):                                        # (B,S,G,N)
        t = t.permute(0, 2, 1, 3)
        return t.reshape(bsz, s, g, h // g, n).sum(3)

    return (dx.permute(0, 2, 1, 3).to(xh.dtype), ddt.permute(0, 2, 1),
            da.sum(0), per_group(dbf).to(bb.dtype),
            per_group(dcf).to(cc.dtype))


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


def _check_tc_route(xh, bb, cc, q, smem=smem_bytes):
    """A bf16 kernel's limits: P and N in TC_DIMS, the chunk's rows within
    shared memory (``smem``: the forward's or the backward's bytes), and
    16-byte aligned bases and strides (cp.async)."""
    p, n = xh.shape[3], bb.shape[3]
    if p not in TC_DIMS or n not in TC_DIMS:
        raise ValueError(f"head_dim {p} / state {n}: the bf16 kernel takes "
                         f"{TC_DIMS}")
    if smem(q, p, n) > SMEM_LIMIT:
        raise ValueError(f"chunk {q} at P {p}, N {n} needs "
                         f"{smem(q, p, n)} B of shared memory; a "
                         f"block may have {SMEM_LIMIT}")
    for name, t in (("xh", xh), ("bb", bb), ("cc", cc)):
        used = [t.stride(d) for d in range(3) if t.shape[d] > 1]
        if t.data_ptr() % 16 or any(st % 8 for st in used):
            raise ValueError(f"{name} must start on 16 bytes and have strides "
                             f"of whole 16-byte vectors for the bf16 kernel "
                             f"(offset {t.data_ptr() % 16}, strides "
                             f"{t.stride()})")


def _launch(xh, dt, a, bb, cc, q):
    """The forward kernel: ``(y, hT, states)``, ``states`` the f32 scratch
    of the state entering every chunk but the first
    (``state_scratch_shape``), which the backward reads."""
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
    states = torch.empty(state_scratch_shape(bsz, h, nc, p, n),
                         dtype=torch.float32, device=xh.device)
    if xh.numel() == 0:
        return y, hT.zero_(), states
    sync = torch.zeros(sync_words(bsz, h, nc), dtype=torch.int32,
                       device=xh.device)
    lib = _build.load_library()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = lib.mist_ssd_scan(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), bb.data_ptr(),
            cc.data_ptr(), y.data_ptr(), hT.data_ptr(), states.data_ptr(),
            sync.data_ptr(), bsz, s, h, g, p, n, q, _DTYPE_CODES[xh.dtype],
            *xh.stride()[:3], *dt.stride(), *bb.stride()[:3],
            *cc.stride()[:3], stream)
    _build.check(err, "ssd scan kernel")
    LAUNCHES += 1
    return y, hT, states


def _check_bwd_tc_route(xh, bb, cc, q):
    """The bf16 backward kernel's limits: P and N in TC_DIMS, chunks of up
    to BWD_MAX_CHUNK rows (one 16-row block a warp), and 16-byte aligned
    bases and strides (cp.async)."""
    if q > BWD_MAX_CHUNK:
        raise ValueError(f"chunk {q}: the bf16 SSD backward takes chunks of "
                         f"up to {BWD_MAX_CHUNK} rows (one 16-row block to "
                         f"each of its {BWD_TC_WARPS} warps)")
    _check_tc_route(xh, bb, cc, q, bwd_smem_bytes)


def _launch_bwd(xh, dt, a, bb, cc, dy, states, q):
    """The backward kernel: ``(dx, ddt, da, dbb, dcc)`` from dy and the
    forward's ``states``.  Outputs and scratch are allocated here: the f32
    parts of dB and dC (``bwd_parts_shape``: one per cluster of heads in
    bf16, per head in f32), da's per-chunk parts, the chain of dH
    ``state_scratch_shape`` and the ticket counter with its flags."""
    global BWD_LAUNCHES
    _check_cuda_inputs(xh, dt, a, bb, cc)
    bsz, s, h, p = xh.shape
    g, n = bb.shape[2], bb.shape[3]
    nc = s // q
    if dy.shape != xh.shape or dy.dtype != xh.dtype or \
            dy.device != xh.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"for y {tuple(xh.shape)} {xh.dtype}")
    want = state_scratch_shape(bsz, h, nc, p, n)
    if tuple(states.shape) != want or states.dtype != torch.float32 or \
            not states.is_contiguous():
        raise ValueError(f"states {tuple(states.shape)} {states.dtype}: the "
                         f"forward's contiguous f32 {want}")
    if xh.dtype == torch.bfloat16:
        _check_bwd_tc_route(xh, bb, cc, q)
    elif bwd_smem_bytes(q, p, n, xh.dtype) > SMEM_LIMIT:
        raise ValueError(f"chunk {q} at P {p}, N {n} ({xh.dtype}) needs "
                         f"{bwd_smem_bytes(q, p, n, xh.dtype)} B of shared "
                         f"memory in the SSD backward; a block may have "
                         f"{SMEM_LIMIT}")
    a, dy = a.contiguous(), dy.contiguous()
    if dy.data_ptr() % 16:  # cp.async reads dy's rows 16 bytes at a time
        dy = dy.clone()
    dev = xh.device
    dx = torch.empty((bsz, s, h, p), dtype=xh.dtype, device=dev)
    ddt = torch.empty((bsz, s, h), dtype=torch.float32, device=dev)
    da = torch.empty((h,), dtype=torch.float32, device=dev)
    dbb = torch.empty((bsz, s, g, n), dtype=bb.dtype, device=dev)
    dcc = torch.empty((bsz, s, g, n), dtype=cc.dtype, device=dev)
    if xh.numel() == 0:
        return dx, ddt.zero_(), da.zero_(), dbb.zero_(), dcc.zero_()
    parts = torch.empty(bwd_parts_shape(bsz, s, h, g, n, xh.dtype),
                        dtype=torch.float32, device=dev)
    da_parts = torch.empty((bsz, h, nc), dtype=torch.float32, device=dev)
    dstates = torch.empty(want, dtype=torch.float32, device=dev)
    sync = torch.zeros(sync_words(bsz, h, nc), dtype=torch.int32,
                       device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mist_ssd_scan_bwd(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), bb.data_ptr(),
            cc.data_ptr(), dy.data_ptr(), states.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), da.data_ptr(), dbb.data_ptr(), dcc.data_ptr(),
            parts.data_ptr(), da_parts.data_ptr(), dstates.data_ptr(),
            sync.data_ptr(), bsz, s, h, g, p, n, q, _DTYPE_CODES[xh.dtype],
            *xh.stride()[:3], *dt.stride(), *bb.stride()[:3],
            *cc.stride()[:3], stream)
    _build.check(err, "ssd scan backward kernel")
    BWD_LAUNCHES += 1
    return dx, ddt, da, dbb, dcc


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernels (a CUDA tensor)."""
    return t.device.type == "cuda"


def _route(xh: torch.Tensor, impl: str) -> str:
    """"plain" or "kernel" for ``impl`` and the inputs' device."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl {impl!r}: 'kernel' or 'plain'")
    if impl == "kernel" and _on_card(xh):
        return "kernel"
    if impl == "plain" or xh.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel for device {xh.device}")


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bb: torch.Tensor, cc: torch.Tensor, *, chunk: int = 256,
             impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """xh (B,S,H,P); dt (B,S,H) f32; a (H,) f32; bb/cc (B,S,G,N) with G
    dividing H -> (y (B,S,H,P) in xh's dtype, hT (B,H,P,N) f32).

    ``impl="kernel"``: the Hopper kernel for CUDA tensors, the plain version
    for CPU tensors.  ``impl="plain"``: the plain version.  The kernel's
    result has no gradient: with autograd on, inputs that require grad
    must come through ``SSDScan`` (``ops.ssd_scan``), and raise here.
    """
    q = chunk_len(chunk, xh.shape[1])
    if _route(xh, impl) == "plain":
        return ssd_plain(xh, dt, a, bb, cc, q)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xh, dt, a, bb, cc)):
        raise RuntimeError(
            "ssd_scan: inputs that require grad reach the SSD kernel outside "
            "its autograd Function, whose result would carry no gradient; "
            "call SSDScan.apply (kernels.ops.ssd_scan)")
    y, hT, _ = _launch(xh, dt, a, bb, cc, q)
    return y, hT


class SSDScan(torch.autograd.Function):
    """(y, hT) = ssd_scan(xh, dt, a, bb, cc) with the gradient of y from
    the SSD backward kernel (the plain ``ssd_bwd_plain`` where the forward
    took the plain version).  The kernel's forward keeps its scratch of
    entering states for the backward; hT is not differentiated (training
    drops it)."""

    @staticmethod
    def forward(ctx, xh, dt, a, bb, cc, chunk: int, impl: str):
        q = chunk_len(chunk, xh.shape[1])
        ctx.route, ctx.q = _route(xh, impl), q
        if ctx.route == "plain":
            y, hT = ssd_plain(xh, dt, a, bb, cc, q)
            states = None
        else:
            y, hT, states = _launch(xh, dt, a, bb, cc, q)
        ctx.save_for_backward(xh, dt, a, bb, cc, states)
        ctx.mark_non_differentiable(hT)
        return y, hT

    @staticmethod
    def backward(ctx, dy, _dhT):
        xh, dt, a, bb, cc, states = ctx.saved_tensors
        if ctx.route == "plain":
            grads = ssd_bwd_plain(xh, dt, a, bb, cc, dy, ctx.q)
        else:
            grads = _launch_bwd(xh, dt, a, bb, cc, dy, states, ctx.q)
        dx, ddt, da, dbb, dcc = grads
        return dx, ddt, da, dbb, dcc, None, None
