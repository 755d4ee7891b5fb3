"""Fused RMSNorm: the Hopper kernel, its wrapper and its plain version (the
port of ``repro/kernels/rmsnorm.py``).

The kernel (``csrc/rmsnorm.cu``) replaces the Pallas TPU kernel
``_rmsnorm_kernel``: over the last dim, the f32 mean of squares, then
``x * rsqrt(var + eps) * f32(scale)``, rounded once to x's dtype.  It takes
bf16 or f32 x (and scale), any number of rows.  One warp owns a row; at the
``RESIDENT_WIDTHS`` (with 16-byte aligned rows) the row stays in registers
between the sum and the scale pass, and every other width takes the
generic two-pass kernel (``vectors_per_lane`` mirrors that choice).  The
plain version is ``ref.rmsnorm_ref``.  ``rmsnorm`` runs the kernel for a
CUDA tensor and the plain version for a CPU tensor; ``impl="plain"`` forces
the plain version (a test hook).  A CUDA tensor never falls back: an
unsupported dtype or a failed launch raises.

The backward kernel (``mist_rmsnorm_bwd`` in the same source) replaces the
gradient ``jax.grad`` takes through the reference's ``layers.norm``: from x
and the incoming gradient it recomputes the row's rsqrt and returns dx (x's
dtype) and dscale (scale's dtype).  One block per SM owns a band of rows
(``bwd_bands``) and reads each row once; at the ``BWD_RING_WIDTHS`` (with
16-byte aligned rows) the rows stream through a shared-memory ring and each
consumer thread keeps ``BWD_COLS`` columns in registers
(``bwd_vectors_per_thread`` mirrors that choice), every other width takes
the generic route.  Each block writes its f32 dscale partials to a
``(blocks, d)`` scratch, and after a grid sync (a cooperative launch) the
blocks add them in a fixed order (``bwd_dscale_order``).  Its plain version
is ``rmsnorm_bwd_ref``.  ``RMSNorm`` is the autograd Function over the two.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build, tiles
from repro_torch.kernels.ref import rmsnorm_bwd_ref, rmsnorm_ref

# launches of the CUDA kernels in this process (the wrappers' counts): the
# forward, and the backward (one per call of its wrapper)
LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's launch shape (csrc/rmsnorm.cu): one warp per row, 8 rows per
# block (the tile menu's one entry, ``tiles.MENU``); rows of these widths
# are held in registers
WARPS_PER_BLOCK = 8
RESIDENT_WIDTHS = (2048, 2560, 4096)


# the backward's launch shape (csrc/rmsnorm.cu): one block per SM, each
# owning a band of rows.  Ring route: CW = d / (32 * BWD_COLS) consumer
# warps and a producer warp, BWD_STAGE_ROWS rows of x and of dy a stage, as
# many stages as BWD_RING_BYTES holds (at most BWD_MAX_STAGES).  Generic
# route: 8 warps over BWD_ROWS rows at a time, its column partials in
# d * 4 bytes of shared memory, which bounds the width.
BWD_RING_WIDTHS = (2560, 4096, 2048)
BWD_COLS = 16
BWD_STAGE_ROWS = 2
BWD_RING_BYTES = 196608
BWD_MAX_STAGES = 8
BWD_ROWS = 4
BWD_MAX_WIDTH = (232448 - 1024) // 4


def bwd_blocks(rows: int, sms: int) -> int:
    """Blocks of the backward's grid (rows of its dscale scratch): one per
    SM, and no more than there are rows."""
    return max(1, min(rows, sms))


def bwd_bands(rows: int, blocks: int):
    """The rows [lo, hi) each block owns (the kernel's ``row_band``)."""
    return [(b * rows // blocks, (b + 1) * rows // blocks)
            for b in range(blocks)]


def bwd_vectors_per_thread(d: int, esize: int, vec_ok: bool) -> int:
    """16-byte vectors of a row that each consumer thread of the ring route
    holds, or 0 for the generic route (the dispatch in ``launch_bwd``)."""
    if vec_ok and d in BWD_RING_WIDTHS:
        return BWD_COLS * esize // 16
    return 0


def bwd_block_warps(d: int, esize: int, vec_ok: bool) -> int:
    """Warps of a backward block: the ring route's consumer warps and its
    producer warp, or the generic route's 8."""
    if bwd_vectors_per_thread(d, esize, vec_ok):
        return d // (32 * BWD_COLS) + 1
    return WARPS_PER_BLOCK


def bwd_ring_stages(d: int, esize: int) -> int:
    """Stages of the ring route's ring (the kernel's ``ring_stages``)."""
    return min(BWD_MAX_STAGES, BWD_RING_BYTES // (2 * BWD_STAGE_ROWS * d
                                                  * esize))


def bwd_dscale_order(blocks: int, warps: int):
    """The order in which the kernel adds the blocks' dscale partials
    (``combine_dscale``): runs of ceil(blocks / warps) consecutive blocks,
    each added in ascending order, then the runs' sums in ascending
    order."""
    per = -(-blocks // warps)
    return [list(range(b, min(blocks, b + per)))
            for b in range(0, blocks, per)]


@functools.cache
def _sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, asked once per device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def blocks_wanted(rows: int) -> int:
    """Blocks for one warp per row, before the kernel caps the grid at the
    blocks the card holds at once."""
    return -(-rows // WARPS_PER_BLOCK)


def vectors_per_lane(d: int, esize: int, vec_ok: bool) -> int:
    """16-byte vectors of a row that each lane holds in registers, or 0 for
    the generic kernel (the dispatch in ``mist_rmsnorm``)."""
    if vec_ok and d in RESIDENT_WIDTHS:
        return d // (32 * (16 // esize))
    return 0


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernels (a CUDA tensor)."""
    return t.device.type == "cuda"


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    global LAUNCHES
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm kernel takes bf16/f32; x {x.dtype}, "
                        f"scale {scale.dtype}")
    if scale.device != x.device:
        raise ValueError(f"scale on {scale.device}, x on {x.device}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} for rows of {d}")
    x = x.contiguous()
    scale = scale.contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    vec_ok = int(x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
                 and (d * x.element_size()) % 16 == 0)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mist_rmsnorm(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                               rows, d, float(eps), _DTYPE_CODES[x.dtype],
                               _DTYPE_CODES[scale.dtype], vec_ok, stream)
    _build.check(err, "rmsnorm kernel")
    LAUNCHES += 1
    return y


def _launch_bwd(x, scale, dy, eps):
    global BWD_LAUNCHES
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm kernel takes bf16/f32; x {x.dtype}, "
                        f"scale {scale.dtype}")
    d = x.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or scale.shape != (d,) \
            or dy.device != x.device or scale.device != x.device:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)}, scale "
                         f"{tuple(scale.shape)} for x {x.dtype} "
                         f"{tuple(x.shape)}")
    if d > BWD_MAX_WIDTH:
        raise ValueError(f"rmsnorm backward kernel takes rows of at most "
                         f"{BWD_MAX_WIDTH}; got {d}")
    x, dy, scale = x.contiguous(), dy.contiguous(), scale.contiguous()
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    blocks = bwd_blocks(rows, _sm_count(x.device.index))
    part = x.new_empty((blocks, d), dtype=torch.float32)
    vec_ok = int(all(t.data_ptr() % 16 == 0 for t in (x, dy, dx))
                 and (d * x.element_size()) % 16 == 0)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mist_rmsnorm_bwd(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), part.data_ptr(), rows, d, float(eps),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], vec_ok, blocks,
            stream)
    _build.check(err, "rmsnorm backward kernel")
    BWD_LAUNCHES += 1
    return dx, dscale


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6, impl: str = "kernel"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``rmsnorm``: x, dy (..., d), scale (d,) -> dx in x's
    dtype, dscale in scale's dtype.  ``impl`` as in ``rmsnorm``."""
    if impl == "plain" or (impl == "kernel" and x.device.type == "cpu"):
        return rmsnorm_bwd_ref(x, scale, dy, eps)
    if impl != "kernel":
        raise ValueError(f"impl {impl!r}: 'kernel' or 'plain'")
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch_bwd(x, scale, dy, eps)


class RMSNorm(torch.autograd.Function):
    """y = rmsnorm(x, scale) with its gradient from ``rmsnorm_bwd``, which
    recomputes the row statistics from the saved x."""

    @staticmethod
    def forward(ctx, x, scale, eps: float, impl: str, block: int = 256):
        ctx.save_for_backward(x, scale)
        ctx.opts = dict(eps=eps, impl=impl)
        return rmsnorm(x, scale, eps=eps, impl=impl, block=block)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), **ctx.opts)
        return dx, dscale, None, None, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            impl: str = "kernel", block: int = 256) -> torch.Tensor:
    """x (..., d), scale (d,) -> (..., d) in x's dtype.  ``block``: the
    plan's ``rmsnorm_block``; the kernel runs 8 rows a block, the tile of
    the default (256) and of the menu's one entry (8), and any other value
    raises before the launch (``tiles.hopper_tile``).  The plain version
    has no tiles."""
    if impl == "plain" or (impl == "kernel" and x.device.type == "cpu"
                           and not _on_card(x)):
        return rmsnorm_ref(x, scale, eps)
    if impl != "kernel":
        raise ValueError(f"impl {impl!r}: 'kernel' or 'plain'")
    if not _on_card(x):
        raise ValueError(f"no kernel for device {x.device}")
    tiles.hopper_tile("rmsnorm_block", block)
    return _launch(x, scale, eps)
