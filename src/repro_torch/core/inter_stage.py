"""Inter-stage tuning: imbalance-aware MILP over Pareto-sampled stage
candidates (paper §5.3, Eq. 1-3).

Objective (Eq. 1), for S stages with stable microbatch times t_i and
first/last-microbatch deltas d_i:

    min  (G - 1) * max_i t_i  +  sum_i t_i  +  max_i (d_i - sum_{j<i} t_j)

 - term 1: pipeline steady state is paced by the bottleneck stage;
 - term 2: pipeline fill/drain (inter-stage imbalance);
 - term 3: inter-MICROBATCH imbalance — the extra work of the first/last
   microbatch counts only where it cannot hide inside the fill bubble
   (sum_{j<i} t_j is stage i's fill slack), Mist's key modeling insight.

Linearization: one-hot x[i,c] over per-stage candidates (layers l_c,
devices n_c, Pareto point (t_c, d_c)); epigraph variables T >= t_i and
D >= d_i - sum_{j<i} t_j make the max terms linear.  Solved with
scipy.optimize.milp (HiGHS; the paper uses CBC).  `solve_exact` is a
brute-force cross-check used by the property tests, and
`simulate_pipeline` is an event-driven 1F1B-style simulator validating the
objective itself.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.intra_stage import ParetoPoint


@dataclass(frozen=True)
class StageCand:
    """One admissible (layers, devices, Pareto point) tuple for a stage."""
    layers: int
    n_devices: int
    t: float
    d: float
    point: Optional[ParetoPoint] = None


def pipeline_objective(ts: Sequence[float], ds: Sequence[float], G: int
                       ) -> float:
    """Paper Eq. 1."""
    ts, ds = list(ts), list(ds)
    fill = [sum(ts[:i]) for i in range(len(ts))]
    return ((G - 1) * max(ts) + sum(ts)
            + max(d - f for d, f in zip(ds, fill)))


def simulate_pipeline(ts: Sequence[float], ds: Sequence[float], G: int,
                      ) -> float:
    """Event-driven GPipe-style makespan with the first/last-microbatch
    extra work attached to each stage (validates Eq. 1; property-tested).

    Each microbatch occupies stage i for t_i (stable) except the first and
    last, which take t_i + first_i / t_i + last_i; we split d_i evenly
    between them (the schedule overlaps both ends symmetrically).
    """
    S = len(ts)
    ready = [0.0] * S      # stage free time
    done = [0.0] * G       # microbatch m leaves stage i
    for i in range(S):
        for m in range(G):
            dur = ts[i]
            if m == 0 or m == G - 1:
                dur = dur + ds[i] / (2.0 if G > 1 else 1.0)
                if G == 1 and m == 0:
                    dur = ts[i] + ds[i]
            start = max(ready[i], done[m])
            ready[i] = start + dur
            done[m] = start + dur
    return max(done)


# ---------------------------------------------------------------------------
# MILP
# ---------------------------------------------------------------------------


@dataclass
class InterStageSolution:
    objective: float
    selection: List[StageCand]       # one per stage
    status: str = "optimal"

    @property
    def ts(self) -> List[float]:
        return [c.t for c in self.selection]

    @property
    def ds(self) -> List[float]:
        return [c.d for c in self.selection]


def solve_milp(cands: Sequence[Sequence[StageCand]], *, total_layers: int,
               total_devices: int, G: int,
               time_limit: float = 30.0) -> Optional[InterStageSolution]:
    """cands[i] = admissible candidates for stage i (from the intra-stage
    Pareto frontiers).  Returns None if infeasible."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    S = len(cands)
    sizes = [len(cs) for cs in cands]
    if any(sz == 0 for sz in sizes):
        return None
    nx = sum(sizes)
    off = np.cumsum([0] + sizes[:-1])
    iT, iD = nx, nx + 1
    nvar = nx + 2

    t_big = max(max(c.t for c in cs) for cs in cands)
    d_big = max(max(c.d for c in cs) for cs in cands)

    cobj = np.zeros(nvar)
    for i, cs in enumerate(cands):
        for j, c in enumerate(cs):
            cobj[off[i] + j] = c.t          # sum_i t_i
    cobj[iT] = G - 1
    cobj[iD] = 1.0

    A, lb, ub = [], [], []

    # one-hot per stage
    for i in range(S):
        row = np.zeros(nvar)
        row[off[i]:off[i] + sizes[i]] = 1.0
        A.append(row); lb.append(1.0); ub.append(1.0)

    # layer + device budgets
    row_l = np.zeros(nvar)
    row_n = np.zeros(nvar)
    for i, cs in enumerate(cands):
        for j, c in enumerate(cs):
            row_l[off[i] + j] = c.layers
            row_n[off[i] + j] = c.n_devices
    A.append(row_l); lb.append(total_layers); ub.append(total_layers)
    A.append(row_n); lb.append(total_devices); ub.append(total_devices)

    # T >= t_i  <=>  T - sum_c x[i,c] t_c >= 0
    for i, cs in enumerate(cands):
        row = np.zeros(nvar)
        row[iT] = 1.0
        for j, c in enumerate(cs):
            row[off[i] + j] = -c.t
        A.append(row); lb.append(0.0); ub.append(np.inf)

    # D >= d_i - sum_{j<i} t_j
    #  <=> D - sum_c x[i,c] d_c + sum_{j<i} sum_c x[j,c] t_c >= 0
    for i, cs in enumerate(cands):
        row = np.zeros(nvar)
        row[iD] = 1.0
        for j, c in enumerate(cs):
            row[off[i] + j] = -c.d
        for jj in range(i):
            for j, c in enumerate(cands[jj]):
                row[off[jj] + j] += c.t
        A.append(row); lb.append(0.0); ub.append(np.inf)

    integrality = np.zeros(nvar)
    integrality[:nx] = 1
    bounds = Bounds(np.concatenate([np.zeros(nx), [0.0, -d_big - 1.0]]),
                    np.concatenate([np.ones(nx), [t_big * S + 1.0,
                                                  d_big + 1.0]]))
    res = milp(c=cobj,
               constraints=LinearConstraint(np.asarray(A), np.asarray(lb),
                                            np.asarray(ub)),
               integrality=integrality, bounds=bounds,
               options={"time_limit": time_limit})
    if not res.success:
        return None
    sel = []
    for i, cs in enumerate(cands):
        xi = res.x[off[i]:off[i] + sizes[i]]
        sel.append(cs[int(np.argmax(xi))])
    obj = pipeline_objective([c.t for c in sel], [c.d for c in sel], G)
    return InterStageSolution(objective=obj, selection=sel)


def solve_exact(cands: Sequence[Sequence[StageCand]], *, total_layers: int,
                total_devices: int, G: int) -> Optional[InterStageSolution]:
    """Brute-force enumeration (exponential; property-test cross-check)."""
    best: Optional[InterStageSolution] = None
    for combo in itertools.product(*cands):
        if sum(c.layers for c in combo) != total_layers:
            continue
        if sum(c.n_devices for c in combo) != total_devices:
            continue
        obj = pipeline_objective([c.t for c in combo],
                                 [c.d for c in combo], G)
        if best is None or obj < best.objective - 1e-12:
            best = InterStageSolution(objective=obj, selection=list(combo),
                                      status="exact")
    return best
