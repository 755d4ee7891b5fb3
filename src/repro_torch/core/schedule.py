"""Overlap-centric schedule template (paper §5.1, Figure 7).

The schedule is *described* here as data — which work runs on which of the
four hardware channels {C (MXU compute), G2G (ICI collectives), D2H, H2D}
during each phase of a training step — and *consumed* by the cost model
(`core/costmodel.py`), which feeds the per-phase channel times through the
interference model (paper Alg. 1) to get overlapped wall time.

Phases of one pipeline-stage step (G microbatches):

  first microbatch   : optimizer-state/master swap-in (H2D) + per-layer
                       decoupled optimizer step (C) + ZeRO param all-gather
                       (G2G) overlap the first forward.  (Mist's "optimizer
                       step decoupling and repositioning": each layer's update
                       runs right before its first forward use.)
  stable microbatches: fwd compute ∥ activation swap-out (D2H) ∥ param
                       all-gather for layer k+1 (G2G);
                       bwd compute ∥ grad reduce-scatter (G2G) ∥ activation
                       swap-in (H2D) ∥ grad-accum swap in/out (D2H/H2D).
  last microbatch    : bwd + the step-wise gradient sync (ZeRO<=1 all-reduce /
                       ZeRO>=2 final reduce-scatter) + optimizer-state/master
                       swap-out (D2H).

The legality rules for a configuration (divisibility, capacity sanity) also
live here so intra-stage enumeration and the runtime agree on what is a
valid point.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import (DEFAULT_KERNEL_CONFIG, KernelConfig, Plan,
                             StageConfig)

# The four interference channels, in the order Alg. 1 consumes them.
CHANNELS = ("C", "G2G", "D2H", "H2D")

# offload ratios are searched on this grid (paper uses continuous ratios
# solved per-stage; a grid keeps the batched sweep dense and is refined by
# `intra_stage.refine_ratios` around the best grid point)
RATIO_GRID = (0.0, 0.25, 0.5, 0.75, 1.0)

# The kernel-config dimension of the grid: (q_block, kv_block, rmsnorm_block,
# ssd_chunk) tuples.  The single default tuple keeps the grid size and
# enumeration order byte-identical to the pre-kernel-tuning grid; the tuner
# swaps in `kernels.autotune.legal_kernel_grid(...)` when the kernel
# dimension is swept.
DEFAULT_KERNEL_GRID: Tuple[Tuple[int, int, int, int], ...] = (
    DEFAULT_KERNEL_CONFIG.astuple(),)


@dataclass(frozen=True)
class Candidate:
    """One intra-stage configuration point (the paper's per-stage knobs)."""
    b: int          # micro batch size
    dp: int
    tp: int
    zero: int       # 0..3
    ckpt: int       # recomputed layers (0..L)
    wo: float
    go: float
    oo: float
    ao: float
    # kernel-config knobs (tile/block sizes); the defaults reproduce the
    # pre-tuning fixed constants so legacy constructors are unchanged
    qb: int = 512   # flash-attention q_block
    kvb: int = 512  # flash-attention kv_block
    rnb: int = 256  # rmsnorm row-block
    sch: int = 256  # ssd_scan chunk

    def to_stage(self, layers: int) -> StageConfig:
        return StageConfig(layers=layers, micro_batch=self.b, dp=self.dp,
                           tp=self.tp, zero=self.zero, ckpt_layers=self.ckpt,
                           wo=self.wo, go=self.go, oo=self.oo, ao=self.ao)

    def kernel_config(self) -> KernelConfig:
        return KernelConfig(attn_q_block=self.qb, attn_kv_block=self.kvb,
                            rmsnorm_block=self.rnb, ssd_chunk=self.sch)


def divisors(n: int) -> List[int]:
    out = [d for d in range(1, n + 1) if n % d == 0]
    return out


def legal_dp_tp(n_devices: int, cfg: ArchConfig,
                max_tp: Optional[int] = None) -> List[Tuple[int, int]]:
    """(dp, tp) splits of a stage's devices.

    TP must divide the head count (GQA: kv heads bound repartitioning of KV;
    we allow tp > kv_heads by replicating KV, matching the runtime's
    divisibility-aware sharding rules) and the MLP hidden dim.
    """
    pairs = []
    for tp in divisors(n_devices):
        if max_tp and tp > max_tp:
            continue
        if cfg.num_heads and cfg.num_heads % tp != 0:
            continue
        if cfg.d_ff and cfg.d_ff % tp and (cfg.moe_d_ff or cfg.d_ff) % tp:
            continue
        pairs.append((n_devices // tp, tp))
    return pairs


def microbatch_choices(global_batch: int, dp: int, grad_accum: int
                       ) -> List[int]:
    """b such that G * b * dp == global_batch for the given G."""
    if global_batch % (dp * grad_accum):
        return []
    return [global_batch // (dp * grad_accum)]


def grad_accum_choices(global_batch: int, n_devices: int,
                       cap: int = 512) -> List[int]:
    """G values the tuner sweeps (paper tunes G; the sweep is embarrassingly
    parallel over G)."""
    return [g for g in divisors(global_batch) if g <= cap]


def ckpt_choices(layers: int, granularity: int = 1) -> List[int]:
    """CKPT_i grid 0..L (paper: integer per stage)."""
    if layers <= 8 or granularity <= 1:
        return list(range(layers + 1))
    return sorted(set(list(range(0, layers + 1, granularity)) + [layers]))


def enumerate_candidates(cfg: ArchConfig, *, n_devices: int, layers: int,
                         global_batch: int, grad_accum: int,
                         zeros: Sequence[int] = (0, 1, 2, 3),
                         ratios: Sequence[float] = RATIO_GRID,
                         ratio_dims: Sequence[str] = ("oo", "ao"),
                         max_tp: Optional[int] = None,
                         ckpt_granularity: int = 1,
                         ckpt_values: Optional[Sequence[int]] = None,
                         kernel_grid: Sequence[Tuple[int, int, int, int]]
                         = DEFAULT_KERNEL_GRID
                         ) -> Iterator[Candidate]:
    """The intra-stage grid.  `ratio_dims` limits which offload knobs are
    swept (`intra_stage.refine_ratios` then descends on those same dims
    around the grid winners; the rest stay pinned at 0 so refinement never
    leaves the declared space).  `ckpt_values` pins the CKPT grid (e.g.
    (layers,) for the Megatron-style fixed-full-recompute baseline space)."""
    cks = (list(ckpt_values) if ckpt_values is not None
           else None)
    for dp, tp in legal_dp_tp(n_devices, cfg, max_tp=max_tp):
        for b in microbatch_choices(global_batch, dp, grad_accum):
            for zero in zeros:
                for ck in (cks if cks is not None
                           else ckpt_choices(layers, ckpt_granularity)):
                    ratio_space = [ratios if d in ratio_dims else (0.0,)
                                   for d in ("wo", "go", "oo", "ao")]
                    for wo, go, oo, ao in itertools.product(*ratio_space):
                        for qb, kvb, rnb, sch in kernel_grid:
                            yield Candidate(b=b, dp=dp, tp=tp, zero=zero,
                                            ckpt=ck, wo=wo, go=go, oo=oo,
                                            ao=ao, qb=qb, kvb=kvb, rnb=rnb,
                                            sch=sch)


# ---------------------------------------------------------------------------
# Struct-of-arrays candidate grid — the compiled-sweep counterpart of
# `enumerate_candidates`.  The (b, dp, tp, zero, ckpt, wo, go, oo, ao)
# cross-product is built directly as flat numpy columns (legality applied as
# vectorized masks over the divisor grid), in exactly the same order the
# nested-loop enumeration yields, so downstream Pareto selection breaks ties
# identically.  `Candidate` views are materialized lazily, only for the few
# frontier survivors.
# ---------------------------------------------------------------------------


GRID_FIELDS = ("b", "dp", "tp", "zero", "ckpt", "wo", "go", "oo", "ao",
               "qb", "kvb", "rnb", "sch")


@dataclass(frozen=True)
class CandidateGrid:
    """Columnar intra-stage candidate set; one float64 array per knob."""
    b: np.ndarray
    dp: np.ndarray
    tp: np.ndarray
    zero: np.ndarray
    ckpt: np.ndarray
    wo: np.ndarray
    go: np.ndarray
    oo: np.ndarray
    ao: np.ndarray
    qb: np.ndarray
    kvb: np.ndarray
    rnb: np.ndarray
    sch: np.ndarray

    def __len__(self) -> int:
        return int(self.b.shape[0])

    def candidate(self, i: int) -> Candidate:
        """Materialize row `i` as a Candidate (lazy view construction)."""
        return Candidate(b=int(self.b[i]), dp=int(self.dp[i]),
                         tp=int(self.tp[i]), zero=int(self.zero[i]),
                         ckpt=int(self.ckpt[i]),
                         wo=float(self.wo[i]), go=float(self.go[i]),
                         oo=float(self.oo[i]), ao=float(self.ao[i]),
                         qb=int(self.qb[i]), kvb=int(self.kvb[i]),
                         rnb=int(self.rnb[i]), sch=int(self.sch[i]))

    def take(self, idx) -> "CandidateGrid":
        return CandidateGrid(**{f: getattr(self, f)[idx]
                                for f in GRID_FIELDS})

    def env(self, *, layers: int, grad_accum: int, inflight: float = 1.0
            ) -> Dict[str, np.ndarray]:
        """Cost-model environment binding every symbol to a column —
        replaces per-object attribute gathering (`env_from_candidates`)."""
        return {
            "b": self.b, "dp": self.dp, "tp": self.tp, "zero": self.zero,
            "ckpt": np.minimum(self.ckpt, float(layers)),
            "wo": self.wo, "go": self.go, "oo": self.oo, "ao": self.ao,
            "qb": self.qb, "kvb": self.kvb, "rnb": self.rnb, "sch": self.sch,
            "L": float(layers), "G": float(grad_accum),
            "inflight": float(inflight),
        }


def legal_dp_tp_mask(n_devices: int, cfg: ArchConfig,
                     max_tp: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized `legal_dp_tp`: (dp, tp) columns over the divisor grid."""
    tp = np.asarray(divisors(n_devices), np.int64)
    ok = np.ones(tp.shape, bool)
    if max_tp:
        ok &= tp <= max_tp
    if cfg.num_heads:
        ok &= (cfg.num_heads % tp) == 0
    if cfg.d_ff:
        ok &= ((cfg.d_ff % tp) == 0) | (((cfg.moe_d_ff or cfg.d_ff) % tp)
                                        == 0)
    tp = tp[ok]
    return n_devices // tp, tp


def candidate_grid(cfg: ArchConfig, *, n_devices: int, layers: int,
                   global_batch: int, grad_accum: int,
                   zeros: Sequence[int] = (0, 1, 2, 3),
                   ratios: Sequence[float] = RATIO_GRID,
                   ratio_dims: Sequence[str] = ("oo", "ao"),
                   max_tp: Optional[int] = None,
                   ckpt_granularity: int = 1,
                   ckpt_values: Optional[Sequence[int]] = None,
                   kernel_grid: Sequence[Tuple[int, int, int, int]]
                   = DEFAULT_KERNEL_GRID
                   ) -> CandidateGrid:
    """Build the same grid as `enumerate_candidates`, as numpy columns."""
    dps, tps = legal_dp_tp_mask(n_devices, cfg, max_tp=max_tp)
    # b is unique per (dp, G): G * b * dp == global_batch, when divisible
    denom = dps * grad_accum
    feasible = (global_batch % denom) == 0
    dps, tps = dps[feasible], tps[feasible]
    bs = global_batch // (dps * grad_accum)
    cks = np.asarray(list(ckpt_values) if ckpt_values is not None
                     else ckpt_choices(layers, ckpt_granularity), np.float64)
    zs = np.asarray(list(zeros), np.float64)
    ratio_space = [np.asarray(ratios if d in ratio_dims else (0.0,),
                              np.float64) for d in ("wo", "go", "oo", "ao")]
    # kernel tuples are a joint dimension (not a cross product of their
    # fields); index them so the meshgrid stays rectangular.  With the
    # single default tuple the extra size-1 axis leaves the raveled order —
    # and therefore Pareto tie-breaking — byte-identical to the old grid.
    kcols = np.asarray(list(kernel_grid), np.float64)
    kidx = np.arange(kcols.shape[0], dtype=np.float64)
    # inner block in nested-loop order: zero (slowest), ckpt, wo, go, oo,
    # ao, kernel (fastest)
    mesh = np.meshgrid(zs, cks, *ratio_space, kidx, indexing="ij")
    zero_i, ck_i, wo_i, go_i, oo_i, ao_i, k_i = (m.ravel() for m in mesh)
    k_i = k_i.astype(np.int64)
    n_in, n_out = zero_i.size, dps.size
    return CandidateGrid(
        b=np.repeat(bs.astype(np.float64), n_in),
        dp=np.repeat(dps.astype(np.float64), n_in),
        tp=np.repeat(tps.astype(np.float64), n_in),
        zero=np.tile(zero_i, n_out), ckpt=np.tile(ck_i, n_out),
        wo=np.tile(wo_i, n_out), go=np.tile(go_i, n_out),
        oo=np.tile(oo_i, n_out), ao=np.tile(ao_i, n_out),
        qb=np.tile(kcols[k_i, 0], n_out), kvb=np.tile(kcols[k_i, 1], n_out),
        rnb=np.tile(kcols[k_i, 2], n_out), sch=np.tile(kcols[k_i, 3], n_out),
    )


# ---------------------------------------------------------------------------
# Legality / sanity of a full Plan (used by tests and the executor)
# ---------------------------------------------------------------------------


def validate_plan(plan: Plan, cfg: ArchConfig, n_devices: int,
                  global_batch: int) -> List[str]:
    """Returns a list of violations (empty = legal)."""
    errs = []
    if plan.total_layers != cfg.num_layers:
        errs.append(f"layers {plan.total_layers} != {cfg.num_layers}")
    if plan.devices != n_devices:
        errs.append(f"devices {plan.devices} != {n_devices}")
    s0 = plan.stages[0]
    if plan.grad_accum * s0.micro_batch * s0.dp != global_batch:
        errs.append(f"G*b*dp = {plan.grad_accum * s0.micro_batch * s0.dp}"
                    f" != global batch {global_batch}")
    for i, st in enumerate(plan.stages):
        if st.micro_batch * st.dp != s0.micro_batch * s0.dp:
            errs.append(f"stage {i}: b*dp mismatch with stage 0")
        if not (0 <= st.zero <= 3):
            errs.append(f"stage {i}: zero={st.zero}")
        if st.ckpt_layers < 0:
            errs.append(f"stage {i}: ckpt<0")
        for r in ("wo", "go", "oo", "ao"):
            v = getattr(st, r)
            if not (0.0 <= v <= 1.0):
                errs.append(f"stage {i}: {r}={v}")
        if cfg.num_heads and cfg.num_heads % st.tp:
            errs.append(f"stage {i}: tp={st.tp} !| heads={cfg.num_heads}")
    kc = plan.kernel
    for f in ("attn_q_block", "attn_kv_block", "rmsnorm_block", "ssd_chunk"):
        v = getattr(kc, f)
        if v < 8 or v & (v - 1):
            errs.append(f"kernel.{f}={v} (want a power of two >= 8)")
    return errs


# ---------------------------------------------------------------------------
# Schedule description (which phase puts which traffic on which channel).
# The cost model reads these flags; tests assert the overlap semantics.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PhaseTraffic:
    """Per-phase channel loads, as symbolic-expression factories resolved by
    the cost model.  This class only fixes *placement* (what overlaps with
    what); magnitudes come from the cost model."""
    name: str                    # "first" | "stable" | "last"
    compute: Tuple[str, ...]     # compute items on channel C
    g2g: Tuple[str, ...]         # ICI collective items
    d2h: Tuple[str, ...]
    h2d: Tuple[str, ...]


# Mist's Figure-7 schedule, transcribed: which cost items land on which
# channel in each phase.  Cost-item names are resolved by costmodel.py.
OVERLAP_SCHEDULE: Tuple[PhaseTraffic, ...] = (
    PhaseTraffic(
        name="first",
        compute=("fwd", "bwd", "recompute", "opt_step"),
        g2g=("tp_fwd", "tp_bwd", "zero3_allgather_fwd", "zero3_allgather_bwd",
             "zero2_reduce_scatter"),
        d2h=("act_offload_out", "grad_offload_out"),
        h2d=("act_offload_in", "grad_offload_in",
             "opt_swap_in", "master_swap_in"),
    ),
    PhaseTraffic(
        name="stable",
        compute=("fwd", "bwd", "recompute"),
        g2g=("tp_fwd", "tp_bwd", "zero3_allgather_fwd", "zero3_allgather_bwd",
             "zero2_reduce_scatter"),
        d2h=("act_offload_out", "grad_offload_out"),
        h2d=("act_offload_in", "grad_offload_in"),
    ),
    PhaseTraffic(
        name="last",
        compute=("fwd", "bwd", "recompute"),
        g2g=("tp_fwd", "tp_bwd", "zero3_allgather_fwd", "zero3_allgather_bwd",
             "zero2_reduce_scatter", "dp_grad_sync"),
        d2h=("act_offload_out", "grad_offload_out",
             "opt_swap_out", "master_swap_out"),
        h2d=("act_offload_in", "grad_offload_in"),
    ),
)


def phase(name: str) -> PhaseTraffic:
    for p in OVERLAP_SCHEDULE:
        if p.name == name:
            return p
    raise KeyError(name)
