"""Intra-stage tuning: Dual-Objective Constrained Optimization (paper §5.3).

Given a stage (its layer count, device count, grad-accum G, memory budget),
find, over the grid of (b, DP, TP, ZeRO, CKPT, WO, GO, OO, AO):

    min_{p,z,o}  alpha * G * t_{p,z,o} + (1 - alpha) * d_{p,z,o}
    s.t.  max(Mem_fwd, Mem_bwd) <= Mem_budget                     (Eq. 4)

for a uniform sample of alpha in [0,1] — the winners over alpha form the
(t, d) Pareto frontier handed to the inter-stage MILP (Eq. 2-3).

The full grid is evaluated in ONE batched substitution into the symbolic
cost model (no per-config simulation), which is the paper's key tuning-speed
idea.  A local ratio-refinement pass then descends on the four offload
ratios around each frontier point (the paper treats them as continuous).

The Eq. 4 feasibility mask is SPEC-EXACT: the memory tape
charges state through the shared state-layout derivation
(`repro_torch.lowering.state_layout`), so a candidate whose indivisible dims
replicate (e.g. an odd vocab at tp=8) is charged what the lowered
program will actually hold — plans selected at the budget boundary are
trustworthy, the regime this dual-objective optimization lives in.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.costmodel import CostParams, StageCostModel
from repro_torch.core.hardware import H100, HardwareSpec
from repro_torch.core.schedule import (DEFAULT_KERNEL_GRID, RATIO_GRID, Candidate,
                                 CandidateGrid, candidate_grid,
                                 enumerate_candidates)

ALL_RATIO_DIMS = ("wo", "go", "oo", "ao")


@dataclass(frozen=True)
class ParetoPoint:
    t: float                  # stable microbatch time (Eq. 5)
    d: float                  # first/last delta (Eq. 6)
    mem: float                # peak bytes
    cand: Candidate

    def dominates(self, o: "ParetoPoint") -> bool:
        return (self.t <= o.t and self.d <= o.d
                and (self.t < o.t or self.d < o.d))


@dataclass
class IntraStageResult:
    """Pareto frontier for one (layers, devices, G) stage hypothesis."""
    layers: int
    n_devices: int
    grad_accum: int
    frontier: List[ParetoPoint]      # sorted by t ascending / d descending
    n_evaluated: int = 0
    n_feasible: int = 0

    def best(self, weight_t: float) -> Optional[ParetoPoint]:
        """argmin over the frontier of weight_t * t + d."""
        if not self.frontier:
            return None
        return min(self.frontier, key=lambda p: weight_t * p.t + p.d)


def pareto_front(pts: Sequence[ParetoPoint], max_points: int = 16
                 ) -> List[ParetoPoint]:
    """Non-dominated (t, d) points, decimated to <= max_points (uniform in
    t-order — the paper's 'Pareto frontier sampling')."""
    if not pts:
        return []
    pts = sorted(pts, key=lambda p: (p.t, p.d))
    front: List[ParetoPoint] = []
    best_d = float("inf")
    for p in pts:
        if p.d < best_d - 1e-12:
            front.append(p)
            best_d = p.d
    if len(front) > max_points:
        idx = np.linspace(0, len(front) - 1, max_points).round().astype(int)
        front = [front[i] for i in sorted(set(idx.tolist()))]
    return front


def pareto_front_indices(t: np.ndarray, d: np.ndarray, max_points: int = 16
                         ) -> np.ndarray:
    """Vectorized `pareto_front` over columnar (t, d): returns the indices
    of the surviving frontier, in ascending-t order.  Selects the identical
    point set (same stable (t, d) sort, same 1e-12 tolerance chain, same
    decimation), so no per-candidate Python objects are needed upstream.
    """
    if t.size == 0:
        return np.empty(0, np.intp)
    order = np.lexsort((d, t))           # stable: by t, then d, then index
    ds = d[order]
    # strict running-min prefilter is a provable superset of the kept chain
    # (any point kept by the tolerance rule lies strictly below the min of
    # everything before it); the exact tolerance scan then runs on the few
    # survivors only.
    prev_min = np.concatenate(([np.inf], np.minimum.accumulate(ds)[:-1]))
    chain = np.nonzero(ds < prev_min)[0]
    keep: List[int] = []
    best_d = float("inf")
    for j in chain.tolist():
        v = float(ds[j])
        if v < best_d - 1e-12:
            keep.append(j)
            best_d = v
    if len(keep) > max_points:
        idx = np.linspace(0, len(keep) - 1, max_points).round().astype(int)
        keep = [keep[i] for i in sorted(set(idx.tolist()))]
    return order[np.asarray(keep, np.intp)]


def tune_stage(cfg: ArchConfig, *, seq_len: int, layers: int, n_devices: int,
               global_batch_per_stage: int, grad_accum: int,
               has_embed: bool = True, has_head: bool = True,
               inflight: float = 1.0,
               hw: HardwareSpec = H100, cp: CostParams = CostParams(),
               zeros: Sequence[int] = (0, 1, 2, 3),
               ratios: Sequence[float] = RATIO_GRID,
               ratio_dims: Sequence[str] = ("oo", "ao"),
               ckpt_granularity: int = 0,
               ckpt_values: Optional[Sequence[int]] = None,
               max_tp: Optional[int] = None,
               max_front: int = 16,
               scm: Optional[StageCostModel] = None,
               refine: bool = True,
               engine: str = "compiled",
               backend: Optional[str] = None,
               kernel_grid: Sequence[Tuple[int, int, int, int]]
               = DEFAULT_KERNEL_GRID) -> IntraStageResult:
    """Batched sweep -> feasible set -> Pareto frontier -> ratio refinement.

    engine="compiled" (default) runs the struct-of-arrays grid through the
    cost model's compiled expression tape and selects the frontier on the
    columnar results; Candidate objects exist only for frontier survivors.
    engine="legacy" is the pre-compilation path (per-object candidate list,
    recursive expression walks, Python Pareto scan) kept as the equivalence
    and speedup baseline — both must return identical frontiers.

    ``backend`` selects the tape evaluation backend ("numpy"|"torch"|"auto",
    see StageCostModel) when this call constructs the cost model; a
    caller-supplied ``scm`` brings its own backend and wins.  Every
    backend returns identical frontiers (tests/test_torch_tuner.py).
    """
    if ckpt_granularity <= 0:
        ckpt_granularity = max(1, layers // 8)
    if engine == "legacy":
        return _tune_stage_legacy(
            cfg, seq_len=seq_len, layers=layers, n_devices=n_devices,
            global_batch_per_stage=global_batch_per_stage,
            grad_accum=grad_accum, has_embed=has_embed, has_head=has_head,
            inflight=inflight, hw=hw, cp=cp, zeros=zeros, ratios=ratios,
            ratio_dims=ratio_dims, ckpt_granularity=ckpt_granularity,
            ckpt_values=ckpt_values, max_tp=max_tp, max_front=max_front,
            scm=scm, refine=refine, kernel_grid=kernel_grid)
    if engine != "compiled":
        raise ValueError(f"unknown engine {engine!r}")
    grid = candidate_grid(
        cfg, n_devices=n_devices, layers=layers,
        global_batch=global_batch_per_stage, grad_accum=grad_accum,
        zeros=zeros, ratios=ratios, ratio_dims=ratio_dims, max_tp=max_tp,
        ckpt_granularity=ckpt_granularity, ckpt_values=ckpt_values,
        kernel_grid=kernel_grid)
    res = IntraStageResult(layers=layers, n_devices=n_devices,
                           grad_accum=grad_accum, frontier=[],
                           n_evaluated=len(grid))
    if not len(grid):
        return res
    scm = scm or StageCostModel(cfg, seq_len, hw=hw, cp=cp,
                                has_embed=has_embed, has_head=has_head,
                                backend=backend or "numpy")
    # memory feasibility (Eq. 4) on the full grid first; runtime + the
    # interference model run only on the feasible survivors.  The kernel
    # VMEM legality (tile working set vs on-core memory) rides on the same
    # pass; the budget is floored at the default config's working set, so
    # with the default kernel grid the mask is identical to the HBM-only one.
    memout = scm.evaluate_memory(grid.env(layers=layers,
                                          grad_accum=grad_accum,
                                          inflight=inflight))
    mem = memout["mem_peak"]
    budget = scm.memory_budget()
    ok = (mem <= budget) & (memout["vmem_peak"] <= scm.vmem_budget_bytes)
    res.n_feasible = int(ok.sum())
    if not ok.any():
        return res
    feas = np.nonzero(ok)[0]
    sub = grid.take(feas)
    times = scm.evaluate_times(sub.env(layers=layers, grad_accum=grad_accum,
                                       inflight=inflight))
    t, d = times["t_stable"], times["d_delta"]
    sel = pareto_front_indices(t, d, max_points=max_front)
    front = [ParetoPoint(t=float(t[j]), d=float(d[j]),
                         mem=float(mem[feas[j]]),
                         cand=grid.candidate(int(feas[j])))
             for j in sel]
    if refine:
        front = pareto_front(
            refine_frontier(front, scm, layers=layers,
                            grad_accum=grad_accum, inflight=inflight,
                            budget=budget, ratio_dims=ratio_dims),
            max_points=max_front)
    res.frontier = front
    return res


def tune_stage_multi_g(cfg: ArchConfig, *, seq_len: int, layers: int,
                       n_devices: int, global_batch_per_stage: int,
                       grad_accums: Sequence[int],
                       has_embed: bool = True, has_head: bool = True,
                       inflight: float = 1.0,
                       hw: HardwareSpec = H100, cp: CostParams = CostParams(),
                       zeros: Sequence[int] = (0, 1, 2, 3),
                       ratios: Sequence[float] = RATIO_GRID,
                       ratio_dims: Sequence[str] = ("oo", "ao"),
                       ckpt_granularity: int = 0,
                       ckpt_values: Optional[Sequence[int]] = None,
                       max_tp: Optional[int] = None,
                       max_front: int = 16,
                       scm: Optional[StageCostModel] = None,
                       refine: bool = True,
                       cached: bool = True,
                       backend: Optional[str] = None,
                       kernel_grid: Sequence[Tuple[int, int, int, int]]
                       = DEFAULT_KERNEL_GRID
                       ) -> Dict[int, "IntraStageResult"]:
    """G-collapsed `tune_stage`: sweep one stage hypothesis for ALL grad
    accumulation choices in a single pass (ROADMAP "collapse the G loop").

    The cost-model time tape is structurally G-independent (it never loads
    the G symbol — only b = batch/(dp*G) differs between the per-G grids),
    and the memory tape likewise, so the per-G grids are concatenated and
    evaluated in ONE substitution: one memory pass over the union, one
    runtime+interference pass over the feasible union rows, then per-G
    Pareto selection and one *batched-across-G* ratio refinement per
    descent iteration.  Every per-row computation is elementwise, so each
    G's slice is bitwise identical to what a standalone `tune_stage` call
    returns — asserted in tests/test_sweep.py.

    ``cached=True`` additionally consults the cost model's knob-tuple
    result cache, which collapses repeated identical sub-sweeps (e.g. the
    same-role middle stages of a deep pipeline differ only in ``inflight``,
    which the time tape never reads).  The cache is backend-agnostic: the
    torch backend is bitwise identical to numpy, so cached
    rows are interchangeable regardless of which backend produced them.

    ``backend`` selects the tape backend when this call constructs the
    cost model (a caller-supplied ``scm`` brings its own); the memory
    union pass and the per-G runtime passes all run through it.
    """
    if ckpt_granularity <= 0:
        ckpt_granularity = max(1, layers // 8)
    scm = scm or StageCostModel(cfg, seq_len, hw=hw, cp=cp,
                                has_embed=has_embed, has_head=has_head,
                                backend=backend or "numpy")
    grids = {}
    results: Dict[int, IntraStageResult] = {}
    for G in grad_accums:
        grid = candidate_grid(
            cfg, n_devices=n_devices, layers=layers,
            global_batch=global_batch_per_stage, grad_accum=G,
            zeros=zeros, ratios=ratios, ratio_dims=ratio_dims, max_tp=max_tp,
            ckpt_granularity=ckpt_granularity, ckpt_values=ckpt_values,
            kernel_grid=kernel_grid)
        grids[G] = grid
        results[G] = IntraStageResult(layers=layers, n_devices=n_devices,
                                      grad_accum=G, frontier=[],
                                      n_evaluated=len(grid))
    live = [G for G in grad_accums if len(grids[G])]
    if not live:
        return results
    # structural cache-key prefix: these arguments determine every grid
    # column exactly (plus the feasible mask for the time envs below), so
    # no content hashing is needed for the knob-tuple cache
    skey = (cfg.name, layers, n_devices, global_batch_per_stage,
            tuple(zeros), tuple(ratios), tuple(ratio_dims),
            tuple(ckpt_values) if ckpt_values is not None else
            ("gran", ckpt_granularity), max_tp, tuple(kernel_grid))

    # ---- one memory pass over the union grid ------------------------------
    envs = {G: grids[G].env(layers=layers, grad_accum=G, inflight=inflight)
            for G in live}
    union = {}
    for k in envs[live[0]]:
        vals = [envs[G][k] for G in live]
        if all(np.ndim(v) == 0 for v in vals) and \
                len({float(v) for v in vals}) == 1:
            union[k] = vals[0]
        else:
            union[k] = np.concatenate(
                [np.broadcast_to(np.asarray(v, np.float64),
                                 (len(grids[G]),)) for v, G in
                 zip(vals, live)])
    offs = np.cumsum([0] + [len(grids[G]) for G in live])
    memout = scm.evaluate_memory(
        union, cache_key=(skey + (tuple(live), float(inflight))
                          if cached else None))
    mem = memout["mem_peak"]
    budget = scm.memory_budget()
    ok = (mem <= budget) & (memout["vmem_peak"] <= scm.vmem_budget_bytes)

    # ---- runtime on the feasible rows, per G (time tape results hit the
    # knob-tuple cache across same-role hypotheses differing only in
    # inflight — the time tape never reads it) ------------------------------
    feas_per_g = {}
    for j, G in enumerate(live):
        sl = slice(offs[j], offs[j + 1])
        ok_g = ok[sl]
        results[G].n_feasible = int(ok_g.sum())
        feas_per_g[G] = np.nonzero(ok_g)[0]
    live_t = [G for G in live if feas_per_g[G].size]
    if not live_t:
        return results

    # ---- per-G Pareto selection ------------------------------------------
    fronts: Dict[int, List[ParetoPoint]] = {}
    for G in live_t:
        feas = feas_per_g[G]
        base = offs[live.index(G)]
        sub = grids[G].take(feas)
        tkey = None
        if cached:
            fd = hashlib.blake2b(np.ascontiguousarray(feas).tobytes(),
                                 digest_size=16).digest()
            # the time tape reads neither G nor inflight: the key carries G
            # only through the b column's G-dependence (b = batch/(dp*G))
            tkey = skey + (G, fd)
        times = scm.evaluate_times(
            sub.env(layers=layers, grad_accum=G, inflight=inflight),
            cache_key=tkey)
        t, d = times["t_stable"], times["d_delta"]
        sel = pareto_front_indices(t, d, max_points=max_front)
        fronts[G] = [ParetoPoint(t=float(t[i]), d=float(d[i]),
                                 mem=float(mem[base + feas[i]]),
                                 cand=grids[G].candidate(int(feas[i])))
                     for i in sel]

    # ---- one batched-across-G refinement ----------------------------------
    if refine and ratio_dims:
        fronts = refine_frontier_grouped(
            fronts, scm, layers=layers, inflight=inflight, budget=budget,
            ratio_dims=ratio_dims)
        for G in fronts:
            fronts[G] = pareto_front(fronts[G], max_points=max_front)
    for G, front in fronts.items():
        results[G].frontier = front
    return results


def _tune_stage_legacy(cfg: ArchConfig, *, seq_len, layers, n_devices,
                       global_batch_per_stage, grad_accum, has_embed,
                       has_head, inflight, hw, cp, zeros, ratios, ratio_dims,
                       ckpt_granularity, ckpt_values, max_tp, max_front, scm,
                       refine, kernel_grid=DEFAULT_KERNEL_GRID
                       ) -> IntraStageResult:
    cands = list(enumerate_candidates(
        cfg, n_devices=n_devices, layers=layers,
        global_batch=global_batch_per_stage, grad_accum=grad_accum,
        zeros=zeros, ratios=ratios, ratio_dims=ratio_dims, max_tp=max_tp,
        ckpt_granularity=ckpt_granularity, ckpt_values=ckpt_values,
        kernel_grid=kernel_grid))
    res = IntraStageResult(layers=layers, n_devices=n_devices,
                           grad_accum=grad_accum, frontier=[],
                           n_evaluated=len(cands))
    if not cands:
        return res
    scm = scm or StageCostModel(cfg, seq_len, hw=hw, cp=cp,
                                has_embed=has_embed, has_head=has_head)
    env = scm.env_from_candidates(cands, layers=layers,
                                  grad_accum=grad_accum, inflight=inflight)
    out = scm.evaluate_recursive(env)
    budget = scm.memory_budget()
    # same recursive-walk discipline for the VMEM legality term
    vmem = np.asarray(scm.vmem_peak.evaluate(scm._env(env), {}), np.float64)
    ok = (out["mem_peak"] <= budget) \
        & (np.broadcast_to(vmem, out["mem_peak"].shape)
           <= scm.vmem_budget_bytes)
    res.n_feasible = int(ok.sum())
    if not ok.any():
        return res
    idx = np.nonzero(ok)[0]
    pts = [ParetoPoint(t=float(out["t_stable"][i]),
                       d=float(out["d_delta"][i]),
                       mem=float(out["mem_peak"][i]), cand=cands[i])
           for i in idx]
    front = pareto_front(pts, max_points=max_front)
    if refine:
        front = pareto_front(
            [refine_ratios(p, scm, layers=layers, grad_accum=grad_accum,
                           inflight=inflight, budget=budget,
                           ratio_dims=ratio_dims,
                           evaluate=scm.evaluate_recursive)
             for p in front],
            max_points=max_front)
    res.frontier = front
    return res


def refine_ratios(p: ParetoPoint, scm: StageCostModel, *, layers: int,
                  grad_accum: int, inflight: float, budget: float,
                  iters: int = 2,
                  ratio_dims: Sequence[str] = ALL_RATIO_DIMS,
                  evaluate: Optional[Callable] = None) -> ParetoPoint:
    """Coordinate descent on the offload ratios around a grid winner — the
    paper treats them as continuous floats (Table 2).  Only the dims the
    active search space actually sweeps (`ratio_dims`) are descended;
    descending the rest would silently escape the declared space (e.g. the
    `offload`/`mist` presets sweep only oo/ao)."""
    best = p
    step = (RATIO_GRID[1] - RATIO_GRID[0]) / 2.0
    evaluate = evaluate or scm.evaluate
    for _ in range(iters):
        cands = []
        for dim in ratio_dims:
            v = getattr(best.cand, dim)
            for nv in (v - step, v + step):
                if 0.0 <= nv <= 1.0:
                    cands.append(dataclasses.replace(best.cand, **{dim: nv}))
        if not cands:
            break
        env = scm.env_from_candidates(cands, layers=layers,
                                      grad_accum=grad_accum,
                                      inflight=inflight)
        out = evaluate(env)
        for i, c in enumerate(cands):
            if out["mem_peak"][i] > budget:
                continue
            q = ParetoPoint(t=float(out["t_stable"][i]),
                            d=float(out["d_delta"][i]),
                            mem=float(out["mem_peak"][i]), cand=c)
            # keep the step-time scalarization improving
            if (grad_accum * q.t + q.d) < (grad_accum * best.t + best.d):
                best = q
        step /= 2.0
    return best


def refine_frontier(front: Sequence[ParetoPoint], scm: StageCostModel, *,
                    layers: int, grad_accum: int, inflight: float,
                    budget: float, ratio_dims: Sequence[str],
                    iters: int = 2) -> List[ParetoPoint]:
    """Batched `refine_ratios` over a whole frontier: per descent iteration
    all points' neighbor candidates are evaluated in ONE substitution
    instead of one call per point.  The per-point greedy updates (same
    neighbor order, same strict-improvement rule) are preserved exactly, so
    the result matches the sequential refinement point for point."""
    best = list(front)
    if not best or not ratio_dims:
        return best
    step = (RATIO_GRID[1] - RATIO_GRID[0]) / 2.0
    for _ in range(iters):
        cands: List[Candidate] = []
        owner: List[int] = []
        for pi, p in enumerate(best):
            for dim in ratio_dims:
                v = getattr(p.cand, dim)
                for nv in (v - step, v + step):
                    if 0.0 <= nv <= 1.0:
                        cands.append(
                            dataclasses.replace(p.cand, **{dim: nv}))
                        owner.append(pi)
        if not cands:
            break
        env = scm.env_from_candidates(cands, layers=layers,
                                      grad_accum=grad_accum,
                                      inflight=inflight)
        out = scm.evaluate(env)
        for i, c in enumerate(cands):
            if out["mem_peak"][i] > budget:
                continue
            pi = owner[i]
            q = ParetoPoint(t=float(out["t_stable"][i]),
                            d=float(out["d_delta"][i]),
                            mem=float(out["mem_peak"][i]), cand=c)
            if (grad_accum * q.t + q.d) < (grad_accum * best[pi].t
                                           + best[pi].d):
                best[pi] = q
        step /= 2.0
    return best


def refine_fronts_batched(fronts: Dict, meta: Dict, scm: StageCostModel, *,
                          budget: float, ratio_dims: Sequence[str],
                          iters: int = 2) -> Dict:
    """`refine_frontier` batched across MANY stage hypotheses at once.

    ``fronts`` maps an arbitrary hashable key -> frontier points;
    ``meta`` maps the same keys -> (layers, inflight, G).  All hypotheses
    must share one cost model (same arch/seq/role) — L and inflight are
    bound as per-row columns, which the tapes broadcast exactly like the
    scalar binding, so every row's result is bitwise identical to the
    per-hypothesis `refine_frontier` call.  One tape + interference pass
    per descent iteration replaces one per (hypothesis, G).
    """
    best = {k: list(ps) for k, ps in fronts.items()}
    keys = [k for k in best if best[k]]
    if not keys or not ratio_dims:
        return best
    step = (RATIO_GRID[1] - RATIO_GRID[0]) / 2.0
    for _ in range(iters):
        cands: List[Candidate] = []
        owner: List[Tuple] = []
        lcol: List[float] = []
        icol: List[float] = []
        for k in keys:
            layers, inflight, _G = meta[k]
            for pi, p in enumerate(best[k]):
                for dim in ratio_dims:
                    v = getattr(p.cand, dim)
                    for nv in (v - step, v + step):
                        if 0.0 <= nv <= 1.0:
                            cands.append(
                                dataclasses.replace(p.cand, **{dim: nv}))
                            owner.append((k, pi))
                            lcol.append(float(layers))
                            icol.append(float(inflight))
        if not cands:
            break
        env = scm.env_from_candidates(cands, layers=0, grad_accum=0)
        L = np.asarray(lcol, np.float64)
        env["L"] = L
        env["inflight"] = np.asarray(icol, np.float64)
        env["ckpt"] = np.minimum(
            np.asarray([c.ckpt for c in cands], np.float64), L)
        out = scm.evaluate(env)
        for i, c in enumerate(cands):
            if out["mem_peak"][i] > budget:
                continue
            k, pi = owner[i]
            G = meta[k][2]
            q = ParetoPoint(t=float(out["t_stable"][i]),
                            d=float(out["d_delta"][i]),
                            mem=float(out["mem_peak"][i]), cand=c)
            if (G * q.t + q.d) < (G * best[k][pi].t + best[k][pi].d):
                best[k][pi] = q
        step /= 2.0
    return best


def refine_frontier_grouped(fronts: Dict[int, List[ParetoPoint]],
                            scm: StageCostModel, *, layers: int,
                            inflight: float, budget: float,
                            ratio_dims: Sequence[str],
                            iters: int = 2) -> Dict[int, List[ParetoPoint]]:
    """`refine_frontier` batched across the G axis of one hypothesis —
    the (layers, inflight)-constant specialization of
    `refine_fronts_batched` (per-row L/inflight binding is bitwise
    identical to the scalar binding, so delegating keeps each G's refined
    frontier identical to a standalone `refine_frontier` call)."""
    meta = {G: (layers, inflight, G) for G in fronts}
    return refine_fronts_batched(fronts, meta, scm, budget=budget,
                                 ratio_dims=ratio_dims, iters=iters)


def alpha_winners(result: IntraStageResult, n_alpha: int = 8
                  ) -> List[ParetoPoint]:
    """Paper Eq. 4: winners of  alpha*G*t + (1-alpha)*d  for uniform alpha
    samples — equivalently a re-sampling of the frontier; exposed for the
    breakdown benchmark."""
    G = result.grad_accum
    out = []
    for a in np.linspace(0.0, 1.0, n_alpha):
        best = min(result.frontier,
                   key=lambda p: a * G * p.t + (1 - a) * p.d,
                   default=None)
        if best is not None and best not in out:
            out.append(best)
    return out
