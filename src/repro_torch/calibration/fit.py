"""Fitting half of the calibration loop (the port of
``repro/calibration/fit.py``).

``attribute_cell`` prices a measured cell through the real cost model at
base constants, keeping the per-phase channel totals (C / G2G / D2H /
H2D) the interference model consumes.  ``fit_scales`` then fits three
group multipliers — compute, collective, DMA — by least squares in log
step time.  The key property making this cheap is *exact scaling*: the
surrogate that divides a channel total by its group scale equals a full
model rebuild with the correspondingly scaled ``CostParams``, because

* scaling ``mxu_eff_peak`` AND ``mxu_eff_floor`` by ``s`` scales the
  matrix-unit efficiency curve — hence 1/compute-time — exactly by ``s``
  (the kernel roofline delta is exactly 0 at default kernel configs,
  which ``attribute_cell`` requires),
* scaling ``ici_eff`` by ``s`` while dividing ``coll_latency_us`` by
  ``s`` scales every collective item exactly by ``1/s``,
* scaling ``host_eff`` by ``s`` scales every offload-DMA item by
  ``1/s``,

so one attribution pass per cell suffices for the whole optimization,
and ``scales_to_overrides`` turns the winning scales back into the
equivalent ``CostParams`` overrides.

``fit_profile`` composes the pieces: scalar fit, an
``InterferenceModel.calibrate`` refit on the scaled stable-phase
channels (it needs two cells whose stable phase runs two channels at
once), a keep-if-better guard (never return a profile that predicts worse
than what it started from), and a per-cell error report.  It also carries
``calibrate_kernels``'s ``KernelCoeffs`` anchors (the kernel bench of
``kernels/autotune.py``) into the profile.

Every function prices against ``hw`` (default: the port's ``H100``); a
profile fitted against one hardware spec is only valid with that spec.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.calibration.measure import MeasuredCell
from repro_torch.calibration.profile import (DEFAULT_PROFILE,
                                             KERNEL_FIELDS,
                                             CalibrationProfile)
from repro_torch.core.costmodel import (TORCH_AUTO_THRESHOLD, CostParams,
                                        StageCostModel, estimate_plan)
from repro_torch.core.costmodel_params import KernelCoeffs
from repro_torch.core.hardware import H100, HardwareSpec
from repro_torch.core.interference import InterferenceModel
from repro_torch.core.plan import DEFAULT_KERNEL_CONFIG
from repro_torch.core.schedule import OVERLAP_SCHEDULE, Candidate

# time-tape item -> fitted group.  Covers every StageCostModel item
# (tests assert the two key sets match, so a new item cannot be silently
# left out of calibration).
ITEM_GROUP: Dict[str, str] = {
    "fwd": "compute", "bwd": "compute", "recompute": "compute",
    "opt_step": "compute",
    "tp_fwd": "collective", "tp_bwd": "collective",
    "zero3_allgather_fwd": "collective", "zero3_allgather_bwd": "collective",
    "zero2_reduce_scatter": "collective", "dp_grad_sync": "collective",
    "zero1_param_allgather": "collective",
    "act_offload_out": "dma", "act_offload_in": "dma",
    "grad_offload_out": "dma", "grad_offload_in": "dma",
    "opt_swap_in": "dma", "opt_swap_out": "dma",
    "master_swap_in": "dma", "master_swap_out": "dma",
}
GROUPS = ("compute", "collective", "dma")
# channel index (C, G2G, D2H, H2D) -> group index: DMA covers both
# directions (one host_eff constant prices both)
_CHANNEL_GROUP = np.array([0, 1, 2, 2])
# fit_scales' search: log10(scale) in [LOG_LO, LOG_HI], SWEEPS cycles of
# golden-section searches to a bracket of TOL (the reference's defaults)
LOG_LO, LOG_HI, SWEEPS, TOL = -5.0, 2.0, 4, 1e-4


@dataclass
class CellAttribution:
    """One cell priced at base constants: phase channel totals + items."""
    label: str
    G: int
    phases: Dict[str, np.ndarray]   # phase name -> (4,) channel seconds
    items: Dict[str, float]         # named time-tape items (per microbatch)
    t_step_pred: float              # base-constant step prediction


def attribute_cell(cell: MeasuredCell, *,
                   profile: CalibrationProfile = DEFAULT_PROFILE,
                   hw: HardwareSpec = H100) -> CellAttribution:
    """Price one measured cell through the real StageCostModel and keep
    the attribution the fit needs."""
    if len(cell.plan.stages) != 1:
        raise ValueError("calibration cells are single-stage (S=1)")
    if cell.plan.kernel != DEFAULT_KERNEL_CONFIG:
        # non-default kernels move t_fwd through the roofline delta, which
        # does NOT rescale with mxu_eff_* — the exact-scaling surrogate
        # would be approximate, so refuse rather than silently drift
        raise ValueError("calibration cells must use the default kernel "
                         "config (exact-scaling surrogate)")
    cfg, shape, stg = cell.config(), cell.shape(), cell.plan.stages[0]
    scm = StageCostModel(cfg, shape.seq_len, hw=hw,
                         sequence_parallel=cell.plan.sequence_parallel,
                         profile=profile)
    kc = cell.plan.kernel
    cand = Candidate(b=stg.micro_batch, dp=stg.dp, tp=stg.tp, zero=stg.zero,
                     ckpt=min(stg.ckpt_layers, stg.layers),
                     wo=stg.wo, go=stg.go, oo=stg.oo, ao=stg.ao,
                     qb=kc.attn_q_block, kvb=kc.attn_kv_block,
                     rnb=kc.rmsnorm_block, sch=kc.ssd_chunk)
    env = scm.env_from_candidates([cand], layers=stg.layers,
                                  grad_accum=cell.plan.grad_accum)
    out = scm.evaluate(env)
    phases = {
        p.name: np.array([float(np.asarray(v).reshape(-1)[0])
                          for v in scm.phase_channels(p, out["items"])],
                         np.float64)
        for p in OVERLAP_SCHEDULE}
    items = {k: float(np.asarray(v).reshape(-1)[0])
             for k, v in out["items"].items()}
    return CellAttribution(label=cell.label, G=cell.plan.grad_accum,
                           phases=phases, items=items,
                           t_step_pred=float(out["t_step"][0]))


def _phase_walls(attr: CellAttribution, scales,
                 intf: InterferenceModel) -> Dict[str, float]:
    inv = 1.0 / np.asarray(scales, np.float64)[_CHANNEL_GROUP]
    return {name: float(intf.predict_stacked(ch * inv))
            for name, ch in attr.phases.items()}


def predict_step_scaled(attr: CellAttribution, scales,
                        intf: InterferenceModel) -> float:
    """Surrogate step-time prediction under group scales — exactly equal
    to rebuilding the model with ``scales_to_overrides`` applied."""
    walls = _phase_walls(attr, scales, intf)
    t_stable = walls["stable"]
    d_delta = (max(walls["first"] - t_stable, 0.0)
               + max(walls["last"] - t_stable, 0.0))
    return attr.G * t_stable + d_delta


def fit_scales(attrs: Sequence[CellAttribution],
               measured: Sequence[float], *,
               intf: Optional[InterferenceModel] = None
               ) -> Tuple[float, float, float]:
    """Least squares in log step time over the three group scales, by
    cyclic coordinate descent with golden-section line search on
    ``log10(scale)`` in ``[LOG_LO, LOG_HI]``.  Pure numpy.  Groups with no
    observed traffic across all cells stay pinned at 1 (they are
    unidentifiable; fitting them would be noise)."""
    intf = intf or InterferenceModel()
    meas = [max(float(m), 1e-30) for m in measured]
    active = [False, False, False]
    for a in attrs:
        tot = np.sum([np.abs(ch) for ch in a.phases.values()], axis=0)
        for g in range(3):
            if float(tot[_CHANNEL_GROUP == g].sum()) > 1e-15:
                active[g] = True

    def loss(logs) -> float:
        s = 10.0 ** np.asarray(logs, np.float64)
        err = 0.0
        for a, m in zip(attrs, meas):
            p = max(predict_step_scaled(a, s, intf), 1e-30)
            err += (math.log(p) - math.log(m)) ** 2
        return err / max(1, len(attrs))

    gr = (math.sqrt(5.0) - 1.0) / 2.0
    logs = np.zeros(3, np.float64)
    for _ in range(SWEEPS):
        for i in range(3):
            if not active[i]:
                continue
            lo, hi = LOG_LO, LOG_HI
            probe = logs.copy()

            def f(v, i=i, probe=probe):
                probe[i] = v
                return loss(probe)

            c = hi - gr * (hi - lo)
            d = lo + gr * (hi - lo)
            fc, fd = f(c), f(d)
            while hi - lo > TOL:
                if fc < fd:
                    hi, d, fd = d, c, fc
                    c = hi - gr * (hi - lo)
                    fc = f(c)
                else:
                    lo, c, fc = c, d, fd
                    d = lo + gr * (hi - lo)
                    fd = f(d)
            logs[i] = (lo + hi) / 2.0
    s = 10.0 ** logs
    return float(s[0]), float(s[1]), float(s[2])


def scales_to_overrides(scales, base: CostParams) -> Dict[str, float]:
    """The CostParams overrides equivalent to the fitted group scales
    (see module docstring for why the equivalence is exact)."""
    s_comp, s_coll, s_dma = (float(s) for s in scales)

    def eff(v: float) -> float:
        return min(0.98, max(1e-9, v))

    out: Dict[str, float] = {}
    if s_comp != 1.0:
        out["mxu_eff_peak"] = eff(base.mxu_eff_peak * s_comp)
        out["mxu_eff_floor"] = eff(base.mxu_eff_floor * s_comp)
    if s_coll != 1.0:
        out["ici_eff"] = eff(base.ici_eff * s_coll)
        out["coll_latency_us"] = base.coll_latency_us / s_coll
    if s_dma != 1.0:
        out["host_eff"] = eff(base.host_eff * s_dma)
    return out


def _kernel_overrides(kc: Optional[KernelCoeffs]) -> Dict[str, float]:
    if kc is None:
        return {}
    base = KernelCoeffs()
    return {f: float(getattr(kc, f)) for f in KERNEL_FIELDS
            if getattr(kc, f) != getattr(base, f)}


def fit_profile(cells: Sequence[MeasuredCell], *,
                base: CalibrationProfile = DEFAULT_PROFILE,
                platform: str = "cpu", hw: HardwareSpec = H100,
                kernel_coeffs: Optional[KernelCoeffs] = None
                ) -> Tuple[CalibrationProfile, Dict]:
    """Fit a CalibrationProfile from measured cells, pricing against
    ``hw``.  Returns ``(profile, report)``; the report carries the
    per-cell predicted-vs-measured table before and after fitting.

    A ``"cuda"`` profile pins the port's measured tape-backend crossover
    (``TORCH_AUTO_THRESHOLD``); other platforms pin none.
    ``kernel_coeffs`` (``calibrate_kernels``) layers its anchors over the
    base's; the cells' frozen-default plans cannot see them."""
    if not cells:
        raise ValueError("no measured cells to fit")
    intf_base = base.interference_model()
    attrs = [attribute_cell(c, profile=base, hw=hw) for c in cells]
    measured = [c.t_measured for c in cells]

    scales = fit_scales(attrs, measured, intf=intf_base)
    base_cp = base.cost_params()
    cost_over = dict(base.cost)
    cost_over.update(scales_to_overrides(scales, base_cp))
    torch_auto_threshold = (TORCH_AUTO_THRESHOLD if platform == "cuda"
                            else None)
    source = f"measured ({len(cells)} cells)"
    kern_over = dict(base.kernels)
    kern_over.update(_kernel_overrides(kernel_coeffs))

    def make_profile(intf_factors) -> CalibrationProfile:
        return CalibrationProfile.make(
            platform=platform, source=source, cost=cost_over,
            kernels=kern_over, interference=intf_factors,
            torch_auto_threshold=torch_auto_threshold)

    # interference refit, where two cells overlap two channels: feed
    # calibrate() the scaled stable-phase channels with the wall time the
    # measurement implies for one stable microbatch ((measured - d_delta)
    # / G)
    intf_fit = None
    inv = 1.0 / np.asarray(scales, np.float64)[_CHANNEL_GROUP]
    samples = []
    for a, m in zip(attrs, measured):
        ch = a.phases["stable"] * inv
        if int((ch > 1e-12).sum()) < 2:
            continue        # single active channel: no overlap to fit
        walls = _phase_walls(a, scales, intf_base)
        d_delta = (max(walls["first"] - walls["stable"], 0.0)
                   + max(walls["last"] - walls["stable"], 0.0))
        wall = (float(m) - d_delta) / max(1, a.G)
        if wall > 0.0:
            samples.append((tuple(float(v) for v in ch), wall))
    n_samples = len(samples)
    if n_samples >= 2:
        model = base.interference_model()
        model.calibrate(samples)
        intf_fit = model.factors

    # evaluate candidates through the REAL model (estimate_plan), not the
    # surrogate — this is the number the report publishes
    def errors(profile: Optional[CalibrationProfile]) -> List[float]:
        out = []
        for c, a in zip(cells, attrs):
            if profile is None:
                pred = a.t_step_pred
            else:
                pred = estimate_plan(c.config(), c.shape(), c.plan, hw=hw,
                                     profile=profile)["t_step"]
            out.append(abs(pred - c.t_measured) / max(c.t_measured, 1e-30))
        return out

    err_uncal = errors(None)
    candidates = [(base, err_uncal)]
    prof_scaled = make_profile(base.interference)
    candidates.append((prof_scaled, errors(prof_scaled)))
    if intf_fit is not None:
        prof_intf = make_profile(intf_fit)
        candidates.append((prof_intf, errors(prof_intf)))
    # keep-if-better: never publish a profile that predicts worse than
    # its own starting point
    profile, err_fit = min(candidates, key=lambda t: float(np.mean(t[1])))

    rows = []
    for c, a, eu, ef in zip(cells, attrs, err_uncal, err_fit):
        t_fit = (a.t_step_pred if profile is base else
                 estimate_plan(c.config(), c.shape(), c.plan, hw=hw,
                               profile=profile)["t_step"])
        rows.append({
            "label": c.label, "t_measured": c.t_measured,
            "t_pred_uncalibrated": a.t_step_pred, "t_pred_fitted": t_fit,
            "err_uncalibrated": eu, "err_fitted": ef,
            "items": a.items, "memory": dict(c.memory),
        })
    report = {
        "platform": platform, "n_cells": len(cells),
        "scales": dict(zip(GROUPS, [float(s) for s in scales])),
        "interference_refit": (intf_fit is not None
                               and profile.interference != base.interference),
        "interference_samples": n_samples,
        "cells": rows,
        "mean_err_uncalibrated": float(np.mean(err_uncal)),
        "mean_err_fitted": float(np.mean(err_fit)),
        "improved": float(np.mean(err_fit)) < float(np.mean(err_uncal)),
    }
    return profile, report


def calibrate_kernels(archs: Sequence[str], *, seq_len: int = 2048,
                      reduced: bool = True, device=None,
                      cache_path=None) -> KernelCoeffs:
    """Anchor the KernelCoeffs ``*_scale`` factors through
    ``kernels.autotune.calibrate`` (its bench of the Hopper kernels on a
    CUDA device, of their plain versions on the CPU, and its cache),
    chained across archs so each arch anchors the ops it actually runs."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.autotune import calibrate

    kc = KernelCoeffs()
    for arch in archs:
        cfg = get_arch(arch)
        if reduced:
            cfg = cfg.reduced()
        kc = calibrate(cfg, seq_len=seq_len, kc=kc, device=device,
                       cache_path=cache_path)
    return kc
