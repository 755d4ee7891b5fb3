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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref

# launches of the CUDA kernel in this process (the wrapper's count)
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's launch shape (csrc/rmsnorm.cu): one warp per row, 8 rows per
# block; rows of these widths are held in registers
WARPS_PER_BLOCK = 8
RESIDENT_WIDTHS = (2560, 4096)


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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            impl: str = "kernel") -> torch.Tensor:
    """x (..., d), scale (d,) -> (..., d) in x's dtype."""
    if impl == "plain" or (impl == "kernel" and x.device.type == "cpu"):
        return rmsnorm_ref(x, scale, eps)
    if impl != "kernel":
        raise ValueError(f"impl {impl!r}: 'kernel' or 'plain'")
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch(x, scale, eps)
