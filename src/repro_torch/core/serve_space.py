"""The ``serve`` search-space preset: tune the plan for INFERENCE.

Serving is a different optimization problem from training (PAPER.md
motivates the regime split; docs/serving.md has the full writeup):
decode is memory-bound — every emitted token streams the local weights
plus the KV prefix — while prefill is compute-bound, and the binding
memory term is the KV cache, which grows with batch × max context.  The
knobs that matter are (dp, tp), ZeRO-3 weight sharding (memory for
collective time), and the KV-cache dtype.

The machinery is deliberately the training tuner's: candidates are
priced by a compiled Expr tape (``ServeCostModel``), the intra-stage
dual objective (t = per-token decode latency, d = one-shot prefill
latency) goes through the SAME ``pareto_front`` sampling, and the
selection reuses the inter-stage MILP with S = 1 and G reinterpreted as
the decode-steps-per-request hypothesis — paper Eq. 1 then reads
``G * t + d``: the latency of prefilling once and decoding G tokens.
``tokens/sec = batch * G / objective`` is the dual throughput reading
of the same objective.

int8 KV (``Plan.kv_cache_dtype``) halves the dominant decode store but
perturbs logits, so the sweep only falls back to it when no bf16
candidate fits the memory budget (and only for cache families the
quantized decode path supports); a plan that merely *could* be smaller
never silently changes numerics.
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.inter_stage import StageCand, solve_milp
from repro_torch.core.intra_stage import ParetoPoint, pareto_front
from repro_torch.core.plan import Plan, single_stage_plan
from repro_torch.core.schedule import Candidate, legal_dp_tp

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.tuner import MistTuner, TuneReport

# weight placement: replicated vs ZeRO-3-sharded (inference has no
# optimizer state, so the intermediate levels are indistinguishable)
SERVE_ZEROS: Tuple[int, ...] = (0, 3)


def int8_kv_supported(cfg: "ArchConfig") -> bool:
    """The quantized decode path covers plain GQA/MHA self-attention KV
    caches (k/v + per-position scales).  MLA latent and enc-dec cross
    caches have no quantized read/write path."""
    return cfg.family in ("dense", "moe", "vlm", "hybrid") \
        and not cfg.kv_lora_rank


def serve_kv_grid(cfg: "ArchConfig") -> Tuple[str, ...]:
    return ("bf16", "int8") if int8_kv_supported(cfg) else ("bf16",)


def _sweep_kv(scm, cands: List[Tuple[int, int, int]], kv: str,
              budget: float, max_front: int) -> List[ParetoPoint]:
    """Price one kv-dtype's candidate grid on the compiled tape and
    Pareto-sample the feasible (t_decode, t_prefill) points."""
    arr = np.asarray(cands, np.float64)
    env = {"dp": arr[:, 0], "tp": arr[:, 1],
           "z1": (arr[:, 2] >= 1).astype(np.float64),
           "z2": (arr[:, 2] >= 2).astype(np.float64),
           "z3": (arr[:, 2] >= 3).astype(np.float64),
           "kv8": np.full(len(cands), 1.0 if kv == "int8" else 0.0)}
    r = scm.evaluate(env)
    mem = np.maximum(r["mem_decode"], r["mem_prefill"])
    batch = scm.batch
    pts = []
    for i, (dp, tp, zero) in enumerate(cands):
        if mem[i] > budget:
            continue
        cand = Candidate(b=max(1, batch // dp), dp=dp, tp=tp, zero=zero,
                         ckpt=0, wo=0.0, go=0.0, oo=0.0, ao=0.0)
        pts.append(ParetoPoint(t=float(r["t_decode"][i]),
                               d=float(r["t_prefill"][i]),
                               mem=float(mem[i]), cand=cand))
    return pareto_front(pts, max_points=max_front)


def serve_plan_from(cand: Candidate, num_layers: int,
                    kv_cache_dtype: str, page_size: int = 0) -> Plan:
    """Materialize the selected candidate: no remat, no offload, no
    accumulation — a pure serving plan ``lower_plan`` threads into
    ``make_prefill_step``/``make_serve_step`` unchanged."""
    return single_stage_plan(
        num_layers, dp=cand.dp, tp=cand.tp, micro_batch=cand.b,
        grad_accum=1, zero=cand.zero, ckpt_layers=0,
        remat_policy="none", kv_cache_dtype=kv_cache_dtype,
        page_size=page_size)


def serve_page_grid(spec) -> Tuple[int, ...]:
    """Page sizes to sweep: ``spec.page_grid`` validated against the
    decode horizon, or ``(0,)`` (contiguous only — the pre-paging
    tuner, byte-identical plans)."""
    if spec.page_grid is None:
        return (0,)
    grid = tuple(int(ps) for ps in spec.page_grid)
    for ps in grid:
        if ps < 0 or (ps and spec.seq_len % ps):
            raise ValueError(
                f"page_grid entry {ps} must be 0 or divide "
                f"seq_len {spec.seq_len}")
    return grid


def _tune_one_page_size(tuner, page_size: int):
    """Sweep kv dtypes x (dp, tp, zero) and run the G MILP for ONE page
    size.  Returns (best, per_sg, n_points, n_milp) where best is
    (objective, G, sol, kv) or None."""
    from repro_torch.core.costmodel import ServeCostModel
    spec, cfg = tuner.spec, tuner.spec.arch
    scm = ServeCostModel(cfg, batch=spec.global_batch,
                         max_len=spec.seq_len, page_size=page_size,
                         hw=tuner.hw, cp=tuner.cp)
    budget = scm.memory_budget()
    grid = [(dp, tp, z)
            for dp, tp in legal_dp_tp(spec.n_devices, cfg,
                                      max_tp=spec.max_tp)
            for z in SERVE_ZEROS]
    n_points = 0
    front: List[ParetoPoint] = []
    chosen_kv = "bf16"
    for kv in serve_kv_grid(cfg):       # bf16 first; int8 only as the
        n_points += len(grid)           # memory-infeasibility fallback
        front = _sweep_kv(scm, grid, kv, budget, spec.max_front)
        if front:
            chosen_kv = kv
            break
    if not front:
        return None, [], n_points, 0
    # decode-steps hypotheses ride the G axis, so the MILP, Eq. 1, and
    # the (S, G) report fields all read identically to training
    best = None
    per_sg: List[Tuple[int, int, float]] = []
    n_milp = 0
    cands = [[StageCand(layers=cfg.num_layers, n_devices=spec.n_devices,
                        t=p.t, d=p.d, point=p) for p in front]]
    for G in tuner.grad_accums():
        sol = solve_milp(cands, total_layers=cfg.num_layers,
                         total_devices=spec.n_devices, G=G)
        n_milp += 1
        if sol is None:                              # pragma: no cover
            continue
        per_sg.append((1, G, sol.objective))
        if best is None or sol.objective < best[0]:
            best = (sol.objective, G, sol, chosen_kv)
    return best, per_sg, n_points, n_milp


def tune_serve(tuner: "MistTuner") -> "TuneReport":
    """`MistTuner.tune()` body for ``space == "serve"``.

    Outer loop: the paged-KV page-size grid (default ``(0,)`` —
    contiguous only).  Each page size gets its own occupancy-aware
    ``ServeCostModel``; the cross-page-size winner is chosen by an
    occupancy-DISCOUNTED score — a contiguous cache is charged
    ``objective / serve_page_fill`` because under a mixed-length trace
    it pins the full horizon per slot while only the fill fraction does
    work, whereas the paged objective already prices its own live
    stream.  The score is used ONLY for comparison: the reported
    objective stays the winner's raw Eq. 1 value, so the default grid
    reports exactly the pre-paging numbers."""
    from repro_torch.core.tuner import TuneReport
    t0 = time.time()
    spec, cp = tuner.spec, tuner.cp
    cfg = spec.arch
    n_points = n_milp = 0
    winner = None  # (score, best-tuple, per_sg, page_size)
    for ps in serve_page_grid(spec):
        best, per_sg, pts, milps = _tune_one_page_size(tuner, ps)
        n_points += pts
        n_milp += milps
        if best is None:
            continue
        score = best[0] * (1.0 if ps else 1.0 / cp.serve_page_fill)
        if winner is None or score < winner[0]:
            winner = (score, best, per_sg, ps)
    dt = time.time() - t0
    if winner is None:
        return TuneReport(plan=None, objective=float("inf"),
                          throughput_samples=0.0, throughput_tokens=0.0,
                          space=spec.space, n_points=n_points,
                          n_milp=n_milp, tune_seconds=dt, infeasible=True,
                          n_swept=n_points)
    _, (obj, G, sol, chosen_kv), per_sg, page_size = winner
    plan = serve_plan_from(sol.selection[0].point.cand, cfg.num_layers,
                           chosen_kv, page_size=page_size)
    return TuneReport(
        plan=plan, objective=obj,
        throughput_samples=spec.global_batch / obj,
        throughput_tokens=spec.global_batch * G / obj,
        space=spec.space, n_points=n_points, n_milp=n_milp,
        tune_seconds=dt, best_S=1, best_G=G, per_sg=per_sg,
        n_swept=n_points)
