"""Analytic parameter counting + per-kernel roofline coefficients.

``param_count`` sums the param shapes of the port's builders on the meta
device exactly (``meta_params``).  The rest of the
module is the kernel-config cost layer: ``KernelCoeffs`` holds the
calibratable per-kernel roofline constants, and ``kernel_time_terms`` /
``kernel_vmem_terms`` are the ONE formula pair shared by

* the symbolic cost model (``core/costmodel.py`` builds them over
  ``Expr`` knobs — ``qb``/``kvb``/``rnb``/``sch`` — so the compiled
  tapes price the kernel dimension of the candidate grid), and
* the concrete predictor (``kernels/autotune.py`` evaluates them with
  floats against bench measurements of the Hopper kernels and anchors the
  per-kernel ``*_scale`` so the prediction is exact at the default config).

Both paths run the same arithmetic in the same order through a tiny
``Ops`` adapter (the ``lowering/state_layout.py`` idiom), so symbolic
and concrete evaluation agree bitwise.  The terms price the Hopper
kernels at the tiles a plan's tuple runs them at (``kernels/tiles.py``):
shared memory per block in place of the reference's VMEM, tensor-core
efficiency per tile edge against wgmma's 64-row minimum in place of its
128-wide MXU (docs/port.md).  At the default tuple they add exactly 0.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict

from repro_torch.core import symbolic as S
from repro_torch.kernels import tiles

if TYPE_CHECKING:
    from repro_torch.configs.base import ArchConfig


@functools.lru_cache(maxsize=None)
def meta_params(cfg: "ArchConfig"):
    """(params, axes) of the port's builders for ``cfg`` on the meta
    device: the reference's names, shapes and logical axes, with no
    allocation and no random draw (the counterpart of the reference's
    ``abstract_params``, which traces the jax init under ``eval_shape``).
    Treat the result as read-only: it is cached per config."""
    from repro_torch.models.zoo import build_model

    return build_model(cfg, "meta").init(None)


def param_count(cfg: "ArchConfig", active_only: bool = False) -> int:
    params, _ = meta_params(cfg)
    total = sum(math.prod(s.shape) for s in params.values())
    if active_only and cfg.num_experts:
        # subtract inactive routed-expert weights
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        inactive = (cfg.num_experts - cfg.num_experts_per_tok) * per_expert
        total -= inactive * cfg.num_layers
    return int(total)


# ---------------------------------------------------------------------------
# Per-kernel roofline coefficients (CostParams.kernels)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelCoeffs:
    """Calibratable roofline constants, one group per kernel (the
    reference's names and starting values; ``attn_mxu_eff`` is the
    tensor-core efficiency at tiles of at least wgmma's 64 rows).

    The ``*_scale`` factors are dimensionless multipliers anchored by
    ``kernels.autotune.calibrate`` so the predicted time of the DEFAULT
    kernel config equals its measured time exactly; the remaining
    coefficients shape the relative cost across tile sizes.  Because
    the cost model prices the kernel dimension as a *delta* against the
    default config, the scales cancel at the defaults and golden plans
    are unaffected by calibration."""
    # flash attention
    attn_bw_eff: float = 0.85        # achieved HBM fraction for tile DMA
    attn_mxu_eff: float = 0.70       # MXU efficiency at aligned tiles
    attn_tile_overhead_us: float = 0.03  # per-grid-step launch cost
    attn_scale: float = 1.0
    # rmsnorm (bandwidth bound)
    rms_bw_eff: float = 0.85
    rms_tile_overhead_us: float = 0.05
    rms_scale: float = 1.0
    # mamba2 SSD chunk scan
    ssd_bw_eff: float = 0.85
    ssd_vpu_eff: float = 0.08        # fraction of peak for the scan math
    ssd_step_overhead_us: float = 0.2
    ssd_scale: float = 1.0

    def replace(self, **kw) -> "KernelCoeffs":
        import dataclasses
        return dataclasses.replace(self, **kw)


def mxu_efficiency(tok, *, eff_peak, eff_floor, sat_tokens):
    """Saturating MXU efficiency at ``tok`` per-device tokens per microbatch.

    The ONE training-side efficiency formula: ``StageCostModel._build``
    evaluates it over ``Expr`` knobs when compiling the time tape, and
    consumers that need the concrete curve (``StageCostModel.mxu_efficiency``,
    ``benchmarks/accuracy.py``) evaluate it over floats/arrays — identical
    arithmetic in identical order, so external users cannot drift from the
    model.  Rises from ``eff_floor`` toward ``eff_peak`` with half-saturation
    at ``sat_tokens``."""
    return eff_floor + (eff_peak - eff_floor) * (tok / (tok + sat_tokens))


# ---------------------------------------------------------------------------
# Ops adapters: the same formula runs over Exprs (tapes) or floats (bench
# predictor); min/max are the only non-native operations the formulas use.
# ---------------------------------------------------------------------------


class KernelSymbolicOps:
    @staticmethod
    def max(a, b):
        return S.smax(S.wrap(a), S.wrap(b))

    @staticmethod
    def min(a, b):
        return S.smin(S.wrap(a), S.wrap(b))

    @staticmethod
    def ceil(a):
        return S.ceil(a)

    @staticmethod
    def eq(a, b):
        # a 0/1 indicator: neither is greater
        return 1.0 - (S.wrap(a) > b) - (S.wrap(b) > a)

    @staticmethod
    def where(c, a, b):
        return S.where(S.wrap(c), a, b)


class KernelConcreteOps:
    @staticmethod
    def max(a, b):
        return a if a >= b else b

    @staticmethod
    def min(a, b):
        return a if a <= b else b

    @staticmethod
    def ceil(a):
        return float(math.ceil(a))

    @staticmethod
    def eq(a, b):
        return 1.0 if a == b else 0.0

    @staticmethod
    def where(c, a, b):
        # the symbolic blend c*a + (1-c)*b with c exactly 0 or 1 is a or b
        return a if c else b


KERNEL_SYMBOLIC_OPS = KernelSymbolicOps()
KERNEL_CONCRETE_OPS = KernelConcreteOps()


def kernel_time_terms(*, seq: int, b, tp, sp_div, qb, kvb, rnb, sch,
                      num_heads: int, head_dim: int, d_model: int,
                      ssd_heads: int, ssd_head_dim: int, ssd_state: int,
                      hbm_bw: float, peak_flops: float, kc: KernelCoeffs,
                      ops=KERNEL_SYMBOLIC_OPS,
                      tile_edge: float = 64.0) -> Dict[str, Any]:
    """Per-layer, per-microbatch, per-device kernel times, by op.

    Returns ``{"attn", "rms", "ssd"}`` seconds.  ``b``/``tp``/``sp_div``
    and the four kernel knobs (the plan's values) may be floats or
    ``Expr``s; everything else is a python scalar.  The caller gates each
    term by whether the arch actually runs that op and multiplies by the
    stage's layer count.  The knobs first become the Hopper tiles they run
    at (``tiles.hopper_tile_expr``: the default maps to the kernels' tiles
    of old, menu entries pass through).

    Model per op:

    * attention -- the Hopper flash forward: K/V stream once per query
      work item of ``qr`` rows, so HBM traffic falls with ``qr``; an edge
      below wgmma's ``tile_edge`` (64) rows runs at proportionally lower
      tensor-core efficiency; each (query item, K/V tile) step pays a
      pipeline overhead.  ``t = max(compute, memory) + overhead``.
    * rmsnorm -- bandwidth bound; the rows a block only set how many
      blocks (launch overheads) cover the rows.
    * ssd scan -- the reference's pricing: intra-chunk matmul work grows
      with the chunk length while the number of sequential state steps
      (and their hand-off + state-materialization traffic) shrinks: an
      interior optimum.
    """
    qr = tiles.hopper_tile_expr("attn_q_block", qb, ops)
    kn = tiles.hopper_tile_expr("attn_kv_block", kvb, ops)
    rw = tiles.hopper_tile_expr("rmsnorm_block", rnb, ops)
    heads = num_heads / tp
    hd = float(head_dim)
    fseq = float(seq)

    # -- flash attention ----------------------------------------------------
    attn_bytes = 2.0 * b * heads * hd * (2.0 * fseq
                                         + 2.0 * fseq * (fseq / qr))
    t_attn_mem = attn_bytes / (hbm_bw * kc.attn_bw_eff)
    align = (ops.min(qr, tile_edge) / tile_edge) \
        * (ops.min(kn, tile_edge) / tile_edge)
    attn_flops = 4.0 * b * heads * fseq * fseq * hd
    t_attn_comp = attn_flops / (peak_flops * kc.attn_mxu_eff * align)
    attn_steps = b * heads * (fseq / qr) * (fseq / kn)
    t_attn = kc.attn_scale * (ops.max(t_attn_comp, t_attn_mem)
                              + attn_steps * kc.attn_tile_overhead_us * 1e-6)

    # -- rmsnorm (2 norms per layer) ---------------------------------------
    rows = b * fseq / sp_div
    rms_bytes = 2.0 * 2.0 * rows * float(d_model) * 2.0
    t_rms_mem = rms_bytes / (hbm_bw * kc.rms_bw_eff)
    rms_steps = 2.0 * rows / rw
    t_rms = kc.rms_scale * (t_rms_mem
                            + rms_steps * kc.rms_tile_overhead_us * 1e-6)

    # -- ssd chunk scan -----------------------------------------------------
    hs, ps, ns = float(ssd_heads), float(ssd_head_dim), float(ssd_state)
    ssd_flops = 4.0 * b * fseq * hs * ps * (ns + sch)
    t_ssd_comp = ssd_flops / (peak_flops * kc.ssd_vpu_eff)
    nchunks = fseq / sch
    ssd_bytes = 2.0 * 2.0 * b * fseq * hs * (ps + 2.0 * ns) \
        + 8.0 * b * nchunks * hs * ns * ps
    t_ssd_mem = ssd_bytes / (hbm_bw * kc.ssd_bw_eff)
    t_ssd = kc.ssd_scale * (ops.max(t_ssd_comp, t_ssd_mem)
                            + b * hs * nchunks
                            * kc.ssd_step_overhead_us * 1e-6)

    return {"attn": t_attn, "rms": t_rms, "ssd": t_ssd}


def kernel_smem_terms(*, qb, kvb, rnb, sch, head_dim: int, d_model: int,
                      ssd_head_dim: int, ssd_state: int,
                      ops=KERNEL_SYMBOLIC_OPS) -> Dict[str, Any]:
    """Shared memory of one block per op, in bytes, at the tiles the
    plan's knobs run at: the larger of the forward's and the backward's
    block for flash attention and the SSD scan (``tiles.flash_fwd_smem``
    and the rest, the sources' own formulas); RMSNorm's forward row of
    scale, which no tile changes.  The cost model's ``vmem_peak`` (the
    reference's name) is their max over the ops the arch runs."""
    kn = tiles.hopper_tile_expr("attn_kv_block", kvb, ops)
    hd = float(head_dim)
    attn = ops.max(tiles.flash_fwd_smem(hd, kn), tiles.flash_bwd_smem(hd, kn))
    rms = float(tiles.rmsnorm_smem(d_model))
    ps, ns = float(ssd_head_dim), float(ssd_state)
    ssd = ops.max(tiles.ssd_fwd_smem(sch, ps, ns, ops),
                  tiles.ssd_bwd_smem(sch, ps, ns, ops))
    return {"attn": attn, "rms": rms, "ssd": ssd}


# the reference's name for the working-set terms
kernel_vmem_terms = kernel_smem_terms


# ---------------------------------------------------------------------------
# Serve-time roofline (docs/serving.md): decode is memory-bound (stream the
# weights + the KV prefix per emitted token), prefill is compute-bound (one
# big prefix matmul).  ONE formula pair over an Ops adapter with
# ``where``/``gt`` (the state_layout adapters), evaluated symbolically by
# ``ServeCostModel`` and concretely by ``estimate_serve_plan`` / tests.
# ---------------------------------------------------------------------------


def serve_time_terms(*, batch, seq_len, dp, tp, z3, n_active: float,
                     n_layers: int, d_model: int, attn_flops_coef: float,
                     cache_bytes, hbm_bw: float, peak_flops: float,
                     ici_bw: float, mxu_eff_peak: float,
                     mxu_eff_floor: float, mxu_sat_tokens: float,
                     decode_mxu_eff: float, coll_latency_us: float,
                     ops) -> Dict[str, Any]:
    """``{"t_decode", "t_prefill"}`` seconds per device.

    * ``t_decode`` — latency of ONE decode step (== per-token latency for
      every sequence in the batch): roofline max of the GEMV compute and
      the HBM stream of local weights + the full local KV prefix
      (steady state at max context — the conservative, SLO-relevant
      point), plus TP collective latency per layer and, under ZeRO-3
      weight sharding, the per-step weight all-gather — the time price
      of the memory the z3 knob saves.
    * ``t_prefill`` — the one-shot prefix cost: prompt-slab matmul flops
      at the saturating MXU efficiency, plus the same TP collectives
      over the token slab and a single z3 all-gather.

    ``batch``/``dp``/``tp``/``z3`` may be floats or ``Expr``s; the rest
    are python scalars.  ``cache_bytes`` is the per-device cache term
    from ``lowering/cache_layout.py`` (symbolic or concrete to match).
    """
    b_local = batch / dp
    w_stream = 2.0 * n_active / tp          # bf16 weight bytes per device
    lat = coll_latency_us * 1e-6
    L = float(n_layers)

    # -- decode step ---------------------------------------------------------
    flops_dec = (2.0 * n_active + attn_flops_coef * seq_len) * b_local / tp
    t_comp = flops_dec / (peak_flops * decode_mxu_eff)
    t_hbm = (w_stream + cache_bytes) / hbm_bw
    roof = ops.where(ops.gt(t_comp, t_hbm), t_comp, t_hbm)
    tp_msg = 2.0 * b_local * float(d_model)
    t_tp = (2.0 * L * (2.0 * (tp - 1.0) / tp) * tp_msg / ici_bw
            + ops.gt(tp, 1.0) * 2.0 * L * lat)
    t_z3 = z3 * ((dp - 1.0) / dp * w_stream / ici_bw
                 + ops.gt(dp, 1.0) * lat * L)
    t_decode = roof + t_tp + t_z3

    # -- prefill (one-shot prefix) -------------------------------------------
    tok_local = batch * seq_len / dp
    sat = ops.where(ops.gt(tok_local, mxu_sat_tokens), 1.0,
                    tok_local / mxu_sat_tokens)
    eff = mxu_eff_floor + (mxu_eff_peak - mxu_eff_floor) * sat
    flops_pre = (2.0 * n_active + attn_flops_coef * seq_len) * tok_local / tp
    pre_msg = 2.0 * tok_local * float(d_model)
    t_pre = (flops_pre / (peak_flops * eff)
             + 2.0 * L * (2.0 * (tp - 1.0) / tp) * pre_msg / ici_bw
             + ops.gt(tp, 1.0) * 2.0 * L * lat
             + z3 * (dp - 1.0) / dp * w_stream / ici_bw)

    return {"t_decode": t_decode, "t_prefill": t_pre}


def ssd_dims(cfg: "ArchConfig"):
    """(heads, head_dim, state) of the arch's SSD scan, or zeros when the
    family has no SSM mixer."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0, 0, 0
    di = cfg.ssm_expand * cfg.d_model
    return di // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
