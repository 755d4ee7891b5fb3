"""The Hopper tile menu: the tiles the hand-written kernels take, what a
plan's ``KernelConfig`` means for them, and their shared memory per block.

Pure python, no torch: the cost model (``core/costmodel_params.py``), the
kernel tuner (``kernels/autotune.py``) and the kernel wrappers all read it,
and sweep workers import it.

The rule (``core/plan.KernelConfig``, docs/port.md "Plan tiles and Hopper
tiles"):

* ``attn_q_block``, ``attn_kv_block`` and ``rmsnorm_block`` hold the
  reference's TPU tiles.  A field at the reference's default
  (``REF_DEFAULT``) runs its Hopper kernel at the tile it always ran
  (``HOPPER_DEFAULT``); any other value must be one of the Hopper menu's
  (``MENU``), which the kernel then runs; anything else raises before a
  launch, with the menu in the message.  No value is rounded or mapped to
  another.
* ``ssd_chunk`` is the chunk itself on every route (the chunk blocks the
  scan's math, so the reference's CPU route and the kernels agree on it):
  the kernels take any chunk whose rows fit (``ssd_scan._check_tc_route``
  and ``_check_bwd_tc_route`` raise otherwise), and the tuner sweeps the
  ``SSD_CHUNKS`` that both the forward and the backward take at the arch's
  P and N (``ssd_chunk_menu``).

So the reference's default tuple runs the kernels exactly as before the
menu existed, and every tuple the tuner picks is one the kernels launch.

The shared-memory formulas are the kernels' own (``smem_bytes`` in each
source), written over an ``ops`` adapter that supplies ``max`` and
``ceil`` so the cost model can also build them over ``Expr`` knobs.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

# the reference's default tuple (core/plan.DEFAULT_KERNEL_CONFIG)
FIELDS = ("attn_q_block", "attn_kv_block", "rmsnorm_block", "ssd_chunk")
REF_DEFAULT: Dict[str, int] = {"attn_q_block": 512, "attn_kv_block": 512,
                               "rmsnorm_block": 256, "ssd_chunk": 256}

# what the kernels run at the reference's default: the flash forward's
# work items of 128 query rows and K/V tiles of 128 keys (the backward's
# blocks of 128 keys), RMSNorm's forward blocks of 8 rows (one a warp),
# the SSD chunk of 256
HOPPER_DEFAULT: Dict[str, int] = {"attn_q_block": 128, "attn_kv_block": 128,
                                  "rmsnorm_block": 8, "ssd_chunk": 256}

# The menu, from what the kernels compile:
# * attn_q_block: query rows of a forward work item.  One value: the two
#   consumer warpgroups of 64 rows are the kernel's structure (one K/V
#   tile serves both), not a template parameter.
# * attn_kv_block: keys of a forward K/V tile and keys a backward block owns
#   (csrc/flash_attention.cu and flash_attention_bwd.cu, template parameter
#   BN): 64 or 128 at every head dim the kernels take.  256 is left out:
#   the forward's S fragment of 256 columns would take 128 more registers
#   a thread than the 232 a consumer has.
# * rmsnorm_block: rows (warps) of a forward block (csrc/rmsnorm.cu,
#   WARPS).  One value: 16 rows a block gave bitwise the same output and was
#   never faster on an H100 (it spills at d 4096), so no second count is
#   launched until one is measured faster at a training width.  The
#   backward's band per SM does not depend on it.
MENU: Dict[str, Tuple[int, ...]] = {"attn_q_block": (128,),
                                    "attn_kv_block": (64, 128),
                                    "rmsnorm_block": (8,)}

# chunks the tuner tries; those both SSD kernels take at the arch's P, N
# form its menu (ssd_chunk_menu)
SSD_CHUNKS: Tuple[int, ...] = (64, 128, 256, 512)

# ---- the kernels' launch constants (mirrored from the sources) -------------

SMEM_LIMIT = 232448          # shared memory a block may have on an H100
FLASH_HEAD_DIMS = (32, 64, 80, 128)
# flash forward: query rows an item, tiles of each kind in shared memory
FWD_BLOCK_M = 128
FWD_Q_STAGES, FWD_K_STAGES, FWD_V_STAGES = 2, 2, 3
# flash backward: query rows a tile, stages of the q/dO ring, of the dS^T
# tiles and of the f32 dQ parts
BWD_BLOCK_M = 64
BWD_Q_STAGES, BWD_DS_STAGES, BWD_DQ_STAGES = 2, 2, 2
# bf16 SSD kernels: rows of an m16n8k16 tile, bf16 padding after a shared
# row, forward warps, backward warps (one 16-row block each: its longest
# chunk), f32 padding after a staged dB / dC row; the P and N they take
SSD_ROW_BLOCK = 16
SSD_SMEM_PAD = 8
SSD_TC_WARPS = 8
SSD_BWD_TC_WARPS = 16
SSD_BWD_MAX_CHUNK = SSD_BWD_TC_WARPS * SSD_ROW_BLOCK
SSD_BWD_STAGE_PAD = 4
SSD_TC_DIMS = (16, 32, 48, 64)


class _ConcreteOps:
    @staticmethod
    def max(a, b):
        return a if a >= b else b

    @staticmethod
    def ceil(a):
        return float(math.ceil(a))


CONCRETE = _ConcreteOps()


# ---- the plan's tuple on Hopper ---------------------------------------------


def hopper_tile(field: str, value: int) -> int:
    """The Hopper tile a plan's ``field`` runs at: the kernel's tile of old
    at the reference's default, the value itself where it is a menu entry;
    anything else raises (no rounding)."""
    if field == "ssd_chunk":
        return int(value)
    if value == REF_DEFAULT[field]:
        return HOPPER_DEFAULT[field]
    if value in MENU[field]:
        return int(value)
    raise ValueError(
        f"kernel.{field}={value} is neither the plan default "
        f"{REF_DEFAULT[field]} (Hopper tile {HOPPER_DEFAULT[field]}) nor "
        f"an entry of the Hopper menu {MENU[field]} (kernels/tiles.py)")


def hopper_tiles(config) -> Tuple[int, int, int, int]:
    """``(q rows, kv keys, rms rows, ssd chunk)`` for a ``KernelConfig``
    (or a 4-tuple in its field order); raises where ``hopper_tile`` does."""
    vals = config.astuple() if hasattr(config, "astuple") else tuple(config)
    return tuple(hopper_tile(f, int(v)) for f, v in zip(FIELDS, vals))


def hopper_tile_expr(field: str, value, ops):
    """``hopper_tile`` over an ``ops`` adapter with ``eq``/``where``: the
    cost model's knob symbols take plan values, so the tapes map them the
    same way (menu entries pass through, the default maps to its tile)."""
    if field == "ssd_chunk":
        return value
    return ops.where(ops.eq(value, float(REF_DEFAULT[field])),
                     float(HOPPER_DEFAULT[field]), value)


# ---- shared memory per block (the sources' smem_bytes) ----------------------


def flash_fwd_smem(hd, kv_block):
    """``smem_bytes(hd, bn)`` of csrc/flash_attention.cu: the double
    buffered Q tiles of 128 rows, the K and V rings of ``kv_block`` rows,
    and a full and an empty mbarrier per tile."""
    tiles = FWD_Q_STAGES + FWD_K_STAGES + FWD_V_STAGES
    return (FWD_Q_STAGES * FWD_BLOCK_M
            + (FWD_K_STAGES + FWD_V_STAGES) * kv_block) * hd * 2 \
        + 8 * 2 * tiles


def flash_bwd_smem(hd, kv_block):
    """``smem_bytes(hd, bn)`` of csrc/flash_attention_bwd.cu: K and V tiles
    of ``kv_block`` rows, the q/dO ring, the dS^T tiles, the f32 dQ parts,
    the lse/delta rows of each stage, 9 mbarriers and the ticket."""
    n_bars = 1 + 2 * BWD_Q_STAGES + 2 * BWD_DQ_STAGES
    return (2 * kv_block * hd * 2
            + 2 * BWD_Q_STAGES * BWD_BLOCK_M * hd * 2
            + BWD_DS_STAGES * kv_block * BWD_BLOCK_M * 2
            + BWD_DQ_STAGES * BWD_BLOCK_M * hd * 4
            + 2 * BWD_Q_STAGES * BWD_BLOCK_M * 4 + 8 * n_bars + 8)


def rmsnorm_smem(d):
    """Static shared memory of a forward block at the register-resident
    widths (the scale row in f32), whatever its rows."""
    return 4 * d


def ssd_fwd_smem(q, p, n, ops=CONCRETE):
    """``tc_smem_bytes`` of csrc/ssd_scan.cu (bf16): x, B, C of the chunk
    padded to whole 16-row tiles, the state twice, and f32 row vectors."""
    qp = ops.ceil(q / SSD_ROW_BLOCK) * SSD_ROW_BLOCK
    return 2 * (qp * (p + SSD_SMEM_PAD) + qp * (n + SSD_SMEM_PAD)
                + 2 * p * (n + SSD_SMEM_PAD)) \
        + 4 * (3 * qp + SSD_TC_WARPS + 4)


def ssd_bwd_smem(q, p, n, ops=CONCRETE):
    """``tc_smem_bytes`` of csrc/ssd_scan_bwd.cu (bf16): x, dy, B, C of the
    padded chunk (a region the f32 dB / dC staging reuses), dH and H_in as
    bf16 hi and lo, nine f32 row vectors, the warps' sums, two scalars and
    the ticket."""
    qp = ops.ceil(q / SSD_ROW_BLOCK) * SSD_ROW_BLOCK
    region = ops.max(
        2 * qp * (2 * (p + SSD_SMEM_PAD) + 2 * (n + SSD_SMEM_PAD)),
        4 * 2 * qp * (n + SSD_BWD_STAGE_PAD))
    return region + 2 * 4 * n * (p + SSD_SMEM_PAD) \
        + 4 * (9 * qp + SSD_BWD_TC_WARPS + 4)


# ---- legality ---------------------------------------------------------------


def kv_block_menu(hd: int) -> Tuple[int, ...]:
    """The ``attn_kv_block`` entries both flash kernels launch at head dim
    ``hd``: () where the kernels lack ``hd``."""
    if hd not in FLASH_HEAD_DIMS:
        return ()
    return tuple(bn for bn in MENU["attn_kv_block"]
                 if max(flash_fwd_smem(hd, bn), flash_bwd_smem(hd, bn))
                 <= SMEM_LIMIT)


def ssd_chunk_menu(p: int, n: int) -> Tuple[int, ...]:
    """The ``SSD_CHUNKS`` both bf16 SSD kernels take at head dim ``p`` and
    state ``n``: the forward's and the backward's shared memory within a
    block's, and the backward's one 16-row block a warp."""
    if p not in SSD_TC_DIMS or n not in SSD_TC_DIMS:
        return ()
    return tuple(q for q in SSD_CHUNKS
                 if q <= SSD_BWD_MAX_CHUNK
                 and ssd_fwd_smem(q, p, n) <= SMEM_LIMIT
                 and ssd_bwd_smem(q, p, n) <= SMEM_LIMIT)
