"""Parallel (S, G) sweep executor with a shared frontier cache.

`MistTuner.tune` enumerates (stage-count S, grad-accum G) hypotheses whose
intra-stage sweeps are embarrassingly parallel (paper §5.3; ROADMAP
"parallelize the (S, G) hypothesis loop").  This module turns that loop
into an explicit three-phase plan:

  1. **Plan**: enumerate every *stage hypothesis* the (S, G) double loop
     will ask for — `SweepUnit = (layers, n_dev, role, inflight)` plus the
     set of G values it is swept under — deduplicate, and drop whatever
     the tuner's frontier memo already holds.  This is the memo's key
     space, computed without sweeping anything.
  2. **Execute**: evaluate the units.  Each unit is G-collapsed
     (`tune_stage_multi_g`): one memory-feasibility pass over the union of
     its per-G grids, per-G runtime passes that share the cost model's
     knob-tuple tape cache, and one batched-across-G ratio refinement per
     descent iteration.  With `workers > 1`, units are sharded across a
     persistent pool of forked worker processes; the shard key groups
     same-(layers, n_dev, role) units so the knob-tuple cache (the time
     tape is inflight-independent) keeps hitting inside a worker.  Each
     worker returns its frontier-memo shard.  (The reference also fans
     shards out to remote daemons over `core/remote.py`; that transport
     is not ported yet, and `hosts` raises.)
  3. **Join**: merge the shards into the tuner's `_frontier_memo`.  The
     (S, G) loop then runs unchanged in the parent — every `_frontier`
     call is a memo hit — followed by the per-cell MILPs and the exact
     same best-cell reduction as the serial engine.

Every unit is computed by the same code on the same inputs regardless of
which worker runs it, so the merged memo — and therefore the selected
plan — is bitwise identical to the serial compiled engine for any worker
count (asserted in tests/test_sweep.py).

The worker pool is created once (fork start method — see
`_start_method` for why fork and not forkserver/spawn) and reused
across `tune()` calls: forking a large scientific-Python process costs
hundreds of milliseconds on some hosts, which would otherwise swallow
the parallel speedup.  Workers receive self-contained
(spec, knobs, units) payloads and cache their tuner/cost-model state
between tasks, so nothing tape-sized ever crosses the process
boundary.  Without fork the executor transparently degrades to
in-process execution.

The port's copy differs in two places.  A forked worker must never touch
CUDA (a child of a process that initialised CUDA cannot use it), so
workers always run the numpy tape backend, as the reference's workers
force numpy over jax; the parent may have initialised CUDA before the
fork.  The per-cell MILPs are solved in the parent, never in a worker:
HiGHS (``scipy.optimize.milp``) hangs in a child forked from a process
that has already run it (scipy 1.17, seen on the CPU).  And a worker
rebuilds its tuner with the parent's hardware spec
and cost parameters, which travel in the payload: the reference's
workers build ``MistTuner(spec)`` with its default hardware, which is
the only one it tunes for.
"""
from __future__ import annotations

import atexit
import multiprocessing as mp
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.intra_stage import (IntraStageResult, pareto_front,
                                    refine_fronts_batched,
                                    tune_stage_multi_g)

# role = (has_embed, has_head)
SweepUnit = Tuple[int, int, Tuple[bool, bool], float]


@dataclass
class SweepStats:
    """Executor-side counters folded into TuneReport."""
    n_units: int = 0
    n_swept: int = 0            # candidate points evaluated across units
    cache_hits: int = 0         # knob-tuple tape-cache hits
    cache_misses: int = 0
    workers_used: int = 1
    memo_entries: int = 0
    hosts_used: int = 0         # remote daemons that served >= 1 shard
    n_host_failures: int = 0    # shards that fell back to local execution


@dataclass(frozen=True)
class SweepPlan:
    """Deduplicated stage hypotheses and the Gs each is swept under."""
    units: Tuple[SweepUnit, ...]
    gs_per_unit: Tuple[Tuple[int, ...], ...]

    def __len__(self) -> int:
        return len(self.units)


def plan_units(tuner, cells: Sequence[Tuple[int, int]], knobs) -> SweepPlan:
    """Mirror the (S, G) double loop's `_frontier` call sites without
    sweeping: which (layers, n_dev, role, inflight) hypotheses will be
    needed, under which G values.  Hypotheses already in the tuner's
    frontier memo (e.g. from a previous `tune()` on the same tuner) are
    skipped.  Order is deterministic (loop order)."""
    spec = tuner.spec
    L, N = spec.arch.num_layers, spec.n_devices
    units: Dict[SweepUnit, List[int]] = {}

    def need(key: SweepUnit, G: int):
        lyr, n_dev, role, inflight = key
        memo_key = tuner._memo_key(layers=lyr, n_dev=n_dev, G=G, role=role,
                                   inflight=inflight, knobs=knobs)
        if memo_key in tuner._frontier_memo:
            return
        units.setdefault(key, [])
        if G not in units[key]:
            units[key].append(G)

    for S, G in cells:
        if spec.space == "uniform" and S > 1:
            if L % S or N % S:
                continue
            need((L // S, N // S, (True, True), float(S)), G)
            continue
        n_dev = N // S
        for i in range(S):
            role = (i == 0, i == S - 1)
            inflight = float(S - i)
            for lyr in tuner._layer_options(S):
                need((lyr, n_dev, role, inflight), G)
    return SweepPlan(units=tuple(units),
                     gs_per_unit=tuple(tuple(g) for g in units.values()))


def _unit_cost(plan: SweepPlan, i: int) -> int:
    """Grid-row estimate for load balancing: the (zeros × ratios) block is
    a shared constant factor, so dp-divisor count × ckpt-grid size × G
    count tracks relative sweep cost well enough for greedy packing."""
    from repro_torch.core.schedule import ckpt_choices, divisors
    lyr, n_dev, _role, _inflight = plan.units[i]
    return (len(divisors(n_dev))
            * len(ckpt_choices(lyr, max(1, lyr // 8)))
            * len(plan.gs_per_unit[i]))


def _shard_units(plan: SweepPlan, workers: int) -> List[List[int]]:
    """Assign unit indices to workers.  Units are grouped by
    (layers, n_dev, role) — the knob-tuple cache key prefix — so
    inflight-only variants land on the same worker and reuse each other's
    time-tape results; groups are then packed greedily by estimated grid
    rows.  Deterministic for a given plan."""
    groups: Dict[Tuple, List[int]] = {}
    for i, (lyr, n_dev, role, _inflight) in enumerate(plan.units):
        groups.setdefault((lyr, n_dev, role), []).append(i)
    order = sorted(groups.values(),
                   key=lambda idxs: (-sum(_unit_cost(plan, i)
                                          for i in idxs), idxs[0]))
    shards: List[List[int]] = [[] for _ in range(workers)]
    load = [0] * workers
    for idxs in order:
        w = min(range(workers), key=lambda j: (load[j], j))
        shards[w].extend(idxs)
        load[w] += sum(_unit_cost(plan, i) for i in idxs)
    return [s for s in shards if s]


def _sweep_units(tuner, plan: SweepPlan, knobs, unit_idxs: Sequence[int]
                 ) -> Tuple[List[Tuple[Tuple, IntraStageResult]], int]:
    """Compute the frontier-memo shard for the given units (pure function
    of (tuner spec, knobs, units) — identical on any worker).

    Sweeps run G-collapsed per unit; ratio refinement is batched one step
    further — across every (unit, G) frontier of a stage role — so each
    descent iteration is ONE tape + interference pass per role instead of
    one per hypothesis (`refine_fronts_batched`; results identical)."""
    spec = tuner.spec
    refine = bool(knobs["ratio_dims"])
    results: Dict[Tuple[int, int], IntraStageResult] = {}
    by_role: Dict[Tuple[bool, bool],
                  Tuple[Dict, Dict]] = {}   # role -> (fronts, meta)
    n_swept = 0
    for i in unit_idxs:
        layers, n_dev, role, inflight = plan.units[i]
        gs = plan.gs_per_unit[i]
        has_embed, has_head = role
        per_g = tune_stage_multi_g(
            spec.arch, seq_len=spec.seq_len, layers=layers, n_devices=n_dev,
            global_batch_per_stage=spec.global_batch, grad_accums=gs,
            has_embed=has_embed, has_head=has_head, inflight=inflight,
            hw=tuner.hw, cp=tuner.cp,
            zeros=knobs["zeros"], ratios=knobs["ratios"],
            ratio_dims=knobs["ratio_dims"],
            ckpt_values={"tune": None, "full": (layers,),
                         "none": (0,)}[knobs["ckpt"]],
            max_tp=spec.max_tp, max_front=spec.max_front,
            scm=tuner.scm(has_embed, has_head), refine=False,
            kernel_grid=tuner.kernel_grid())
        fronts, meta = by_role.setdefault(role, ({}, {}))
        for G, res in per_g.items():
            results[(i, G)] = res
            n_swept += res.n_evaluated
            if refine and res.frontier:
                fronts[(i, G)] = res.frontier
                meta[(i, G)] = (layers, inflight, G)
    if refine:
        for role, (fronts, meta) in by_role.items():
            if not fronts:
                continue
            scm = tuner.scm(*role)
            refined = refine_fronts_batched(
                fronts, meta, scm, budget=scm.memory_budget(),
                ratio_dims=knobs["ratio_dims"])
            for key, front in refined.items():
                results[key].frontier = pareto_front(
                    front, max_points=spec.max_front)
    shard: List[Tuple[Tuple, IntraStageResult]] = []
    for (i, G), res in results.items():
        layers, n_dev, role, inflight = plan.units[i]
        shard.append((tuner._memo_key(layers=layers, n_dev=n_dev, G=G,
                                      role=role, inflight=inflight,
                                      knobs=knobs), res))
    return shard, n_swept


# ---------------------------------------------------------------------------
# persistent worker pool
# ---------------------------------------------------------------------------

_POOL = None
_POOL_SIZE = 0
_CLEAR_BARRIER = None

# worker-process state: the tuner rebuilt from the last task's spec
# (compiled tapes and caches persist across tasks of the same spec)
_WORKER_TUNER = {"key": None, "tuner": None}


def _start_method():
    """Fork, or None (= run in-process).

    fork is deliberate: forkserver/spawn re-import ``__main__`` in every
    worker, which re-executes unguarded user scripts and breaks
    stdin/REPL sessions outright — far worse failure modes than fork's
    theoretical hazard (forking a parent whose BLAS or CUDA threads hold
    an internal lock mid-fork).  That hazard is narrow here: workers never
    touch CUDA (the sweep path is numpy/scipy only, and the meta-device
    shape probes allocate nothing), and OpenBLAS and glibc malloc
    register fork handlers.  If a fork-related hang is ever suspected,
    ``workers=1`` (or 0) sidesteps the pool entirely with identical
    results."""
    return "fork" if "fork" in mp.get_all_start_methods() else None


def _get_pool(n: int):
    global _POOL, _POOL_SIZE, _CLEAR_BARRIER
    if _POOL is not None and _POOL_SIZE >= n:
        return _POOL
    if _POOL is not None:
        _POOL.terminate()
    ctx = mp.get_context(_start_method())
    # created BEFORE the pool so the forked workers inherit it; used by
    # clear_worker_caches to guarantee one clear task lands per worker
    _CLEAR_BARRIER = ctx.Barrier(n)
    _POOL = ctx.Pool(processes=n)
    _POOL_SIZE = n
    return _POOL


def shutdown_pool():
    """Terminate the persistent worker pool (atexit; also handy in tests)."""
    global _POOL, _POOL_SIZE, _CLEAR_BARRIER
    if _POOL is not None:
        _POOL.terminate()
        _POOL = None
        _POOL_SIZE = 0
        _CLEAR_BARRIER = None


atexit.register(shutdown_pool)


def _pool_task(payload: bytes):
    import dataclasses
    spec, hw, cp, knobs, plan, unit_idxs = pickle.loads(payload)
    # Forked workers always sweep on the numpy tape backend: a child of a
    # process that initialised CUDA cannot use CUDA, and every backend
    # returns bitwise-identical frontiers anyway, so the substitution is
    # invisible in the merged memo.  Normalizing the spec — including the
    # execution-routing fields device/hosts/memo_dir/workers, which never
    # affect a unit's frontier — lets every spec variant that differs
    # only in routing share one worker tuner.
    spec = dataclasses.replace(spec, backend="numpy", device=None,
                               hosts=None, memo_dir=None, workers=1)
    key = pickle.dumps((spec, hw, cp, knobs))
    if _WORKER_TUNER["key"] != key:
        from repro_torch.core.tuner import MistTuner
        _WORKER_TUNER["key"] = key
        _WORKER_TUNER["tuner"] = MistTuner(spec, hw=hw, cp=cp)
    tuner = _WORKER_TUNER["tuner"]
    base_h = sum(m.cache_hits for m in tuner._scm_cache.values())
    base_m = sum(m.cache_misses for m in tuner._scm_cache.values())
    shard, n_swept = _sweep_units(tuner, plan, knobs, unit_idxs)
    hits = sum(m.cache_hits for m in tuner._scm_cache.values()) - base_h
    misses = sum(m.cache_misses for m in tuner._scm_cache.values()) - base_m
    return shard, n_swept, hits, misses


def warm_pool(workers: int) -> bool:
    """Create the worker pool ahead of time (session setup): benchmarks
    call this + `clear_worker_caches()` before the timer so a cold-cache
    measurement includes neither the one-time fork cost nor stale result
    caches.  Returns False when no pool can be used."""
    if workers > 1 and _start_method() is not None:
        _get_pool(workers)
        return True
    return False


def _clear_task(_):
    """Drop this worker's knob-tuple result caches (compiled tapes and
    the cached tuner stay — they are session infrastructure, not per-tune
    results).  The barrier guarantees every pool worker executes exactly
    one of these before any returns: a bare Pool.map gives no
    per-process delivery guarantee, so without it a fast worker could
    absorb several clear tasks and leave another warm."""
    tuner = _WORKER_TUNER.get("tuner")
    if tuner is not None:
        for scm in tuner._scm_cache.values():
            scm._tape_cache.clear()
            scm.cache_hits = 0
            scm.cache_misses = 0
    try:
        _CLEAR_BARRIER.wait(timeout=60)
    except Exception:           # broken barrier: degrade, don't hang
        return False
    return True


def clear_worker_caches() -> bool:
    """Deterministically reset every pool worker's knob-tuple caches
    (benchmarks measure cold-cache parallel runs against this).  Returns
    True when every worker confirmed the clear; a broken barrier (e.g. a
    worker respawned mid-clear) is surfaced as a warning + False so a
    benchmark never silently reports warm runs as cold.  No-op (True)
    when no pool is live."""
    if _POOL is None:
        return True
    ok = all(_POOL.map(_clear_task, range(_POOL_SIZE), chunksize=1))
    if not ok:
        import warnings
        warnings.warn("clear_worker_caches: barrier broke; some workers "
                      "may still hold warm caches (pool restart gives a "
                      "guaranteed cold state)", RuntimeWarning)
    return ok


def prefetch_frontiers(tuner, cells: Sequence[Tuple[int, int]], knobs,
                       workers: int = 1,
                       hosts: Optional[Sequence[str]] = None) -> SweepStats:
    """Phases 1-3: plan units, execute (in-process or across the worker
    pool), merge the frontier-memo shards into `tuner._frontier_memo`.
    ``hosts`` (the reference's remote fan-out) raises: not ported yet.

    After this returns, the tuner's (S, G) loop runs entirely from the
    memo; results are identical to the un-prefetched serial engine."""
    if hosts:
        raise NotImplementedError(
            "the multi-host sweep is not ported yet (queue A: core/remote.py "
            "and service/, ROADMAP.md)")
    plan = plan_units(tuner, cells, knobs)
    stats = SweepStats(n_units=len(plan))
    if not len(plan):
        stats.memo_entries = len(tuner._frontier_memo)
        return stats
    workers = max(1, int(workers))
    shards = _shard_units(plan, workers) if workers > 1 else \
        [list(range(len(plan)))]
    use_pool = len(shards) > 1 and _start_method() is not None
    if use_pool:
        # size the pool at the requested worker count even when this
        # plan sharded smaller, so a later tune never has to recreate the
        # pool and throw the warm worker caches away
        pool = _get_pool(workers)
        payloads = [pickle.dumps((tuner.spec, tuner.hw, tuner.cp, knobs,
                                  plan, s))
                    for s in shards]
        outs = pool.map(_pool_task, payloads)
        stats.workers_used = len(shards)
        for shard, n_swept, hits, misses in outs:
            tuner._frontier_memo.update(shard)
            stats.n_swept += n_swept
            stats.cache_hits += hits
            stats.cache_misses += misses
    else:
        base_h = sum(m.cache_hits for m in tuner._scm_cache.values())
        base_m = sum(m.cache_misses for m in tuner._scm_cache.values())
        shard, n_swept = _sweep_units(tuner, plan, knobs,
                                      list(range(len(plan))))
        tuner._frontier_memo.update(shard)
        stats.n_swept += n_swept
        stats.cache_hits = sum(m.cache_hits
                               for m in tuner._scm_cache.values()) - base_h
        stats.cache_misses = sum(
            m.cache_misses for m in tuner._scm_cache.values()) - base_m
        stats.workers_used = 1
    stats.memo_entries = len(tuner._frontier_memo)
    return stats
