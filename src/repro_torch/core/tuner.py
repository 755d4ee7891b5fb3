"""MistTuner: imbalance-aware hierarchical tuning (paper §5.3, Fig. 6).

Pipeline:  for each (S, G) hypothesis
             intra-stage batched sweep  ->  (t, d) Pareto frontier per stage
             inter-stage MILP over frontier samples (Eq. 2-3)
           pick the best (S, G) by Eq. 1.

Search-space presets reproduce the paper's baselines (Fig. 13 breakdown);
docs/search-spaces.md documents each preset's exact knob grid and which
baseline system it corresponds to:

    megatron   parallelism only, full CKPT, ZeRO-1       (Megatron-LM space)
    ckpt       + activation-checkpoint tuning            (Aceso/AdaPipe space)
    zero       + ZeRO level tuning                       (DeepSpeed space)
    offload    + offload-ratio tuning
    mist       everything co-tuned (+ imbalance awareness)
    uniform    mist knobs but one shared config for all stages
               (Yuan et al.-style heuristic)

The (S, G) loop itself is executed by the sweep executor in
core/sweep.py (`TuneSpec.workers`); docs/architecture.md has the full
dataflow of one tune() call.

The port's copy of ``repro/core/tuner.py``: the same search, the same
plans (``tests/test_torch_tuner.py`` holds the golden fixtures and the
test_system workload byte for byte), with the H100 as the default
hardware and a torch tape backend in place of jax.  The stage model's
Eq. 4 feasibility evaluates the reference's state-layout derivation
(``repro_torch.lowering.state_layout``), the derivation the lowering's
``memory_consistency`` evaluates concretely.  ``profile`` takes a
calibration profile (``repro_torch.calibration``).  ``kernel_tune``
sweeps the Hopper tile menu (``repro_torch.kernels.autotune``).  What
waits raises with a pointer to ROADMAP.md: ``hosts`` (the remote
sweep).
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.costmodel import BACKENDS, CostParams, StageCostModel
from repro_torch.core.hardware import H100, HardwareSpec
from repro_torch.core.inter_stage import (InterStageSolution, StageCand,
                                    pipeline_objective, solve_milp)
from repro_torch.core.intra_stage import IntraStageResult, ParetoPoint, tune_stage
from repro_torch.core.plan import DEFAULT_KERNEL_CONFIG, Plan, StageConfig
from repro_torch.core.schedule import (DEFAULT_KERNEL_GRID, RATIO_GRID,
                                 grad_accum_choices)

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.calibration.profile import CalibrationProfile

SPACES = ("none", "megatron", "ckpt", "zero", "offload", "mist", "uniform",
          "serve")


@dataclass(frozen=True)
class TuneSpec:
    arch: ArchConfig
    seq_len: int
    global_batch: int
    n_devices: int
    space: str = "mist"
    imbalance_aware: bool = True
    stage_counts: Optional[Sequence[int]] = None   # default: pow2 divisors
    grad_accums: Optional[Sequence[int]] = None
    layer_window: int = 2       # +- around uniform layers-per-stage
    max_front: int = 12
    max_tp: Optional[int] = None
    # "compiled": expression tape + struct-of-arrays grid + cross-(S, G)
    # frontier memoization.  "legacy": the pre-compilation interpreted path,
    # kept as the equivalence/speedup baseline (identical results).
    engine: str = "compiled"
    # tape evaluation backend ("numpy" | "torch" | "auto", see
    # StageCostModel): "torch" runs the compiled tapes as float64 torch
    # ops on ``device``, bitwise identical to numpy (correctly rounded ops
    # only; a tape with others raises).  "auto" additionally switches per
    # tape run on grid size.  The selected plan is therefore identical
    # for every value (tests/test_torch_tuner.py, chip_smoke.py).
    backend: str = "numpy"
    # where "torch"/"auto" run the tapes: cuda unless this says "cpu"
    # (raises with no CUDA device)
    device: Optional[str] = None
    # (S, G) sweep execution (core/sweep.py; docs/architecture.md):
    #   0   plain in-loop sweeps (the serial compiled engine, kept as
    #       the speedup baseline),
    #   1   G-collapsed executor in-process (default),
    #   >=2 G-collapsed executor across that many forked worker processes,
    #       frontier-memo shards merged at the join.
    # The selected plan is identical for every value (asserted in tests).
    workers: int = 1
    # Kernel-config dimension (core/plan.KernelConfig; docs/kernel-tuning.md):
    # False sweeps only the default (q_block=512, kv_block=512, rmsnorm=256,
    # ssd_chunk=256) tile tuple — the roofline delta term is exactly 0 there,
    # so plans are byte-identical to the pre-kernel-tuning tuner.  True
    # enlarges the grid with the legal tuples of the Hopper tile menu
    # (repro_torch.kernels.autotune.legal_kernel_grid: tiles the kernels
    # launch forward and backward, seq-len divisibility, shared memory a
    # block) as a joint per-candidate dimension.
    kernel_tune: bool = False
    # Explicit grid override ((q_block, kv_block, rmsnorm_block, ssd_chunk)
    # tuples) — takes precedence over kernel_tune; mainly for tests and
    # benchmarks that want a pinned, reproducible kernel sweep.
    kernel_grid: Optional[Tuple[Tuple[int, int, int, int], ...]] = None
    # Multi-host sweep fan-out (the reference's core/remote.py and
    # service/): not ported yet, so a non-empty value raises.
    hosts: Optional[Tuple[str, ...]] = None
    # Persistent content-addressed memo store (core/memo_store.py):
    # directory where frontier-memo units and whole tune reports are
    # cached across processes.  Warm stage hypotheses are preloaded
    # before planning (plan_units drops them from the sweep) and a warm
    # whole-query report short-circuits tune() entirely
    # (TuneReport.from_memo).  Purely an execution accelerator: results
    # are byte-identical with or without it.
    memo_dir: Optional[str] = None
    # Paged-KV page-size grid for the serve space (core/serve_space.py;
    # docs/continuous-batching.md): token page sizes to sweep alongside
    # the kv grid, each priced by its own occupancy-aware ServeCostModel.
    # None sweeps only page_size = 0 (contiguous cache), whose exprs are
    # byte-identical to the pre-paging serve tuner — golden serve
    # fixtures stay stable.  Entries must divide seq_len; 0 may be
    # included to let the contiguous layout compete.
    page_grid: Optional[Tuple[int, ...]] = None
    # Measured calibration profile (repro_torch.calibration): fitted
    # constants layered over the default cost model.  Hashable and
    # picklable, so sweep workers rebuild MistTuner from the pickled spec
    # — a profile travels with it and every worker prices identically.
    profile: Optional["CalibrationProfile"] = None


@dataclass
class TuneReport:
    plan: Optional[Plan]
    objective: float            # Eq. 1 step-time estimate (seconds)
    throughput_samples: float
    throughput_tokens: float
    space: str
    n_points: int               # candidate configurations considered
    n_milp: int
    tune_seconds: float
    best_S: int = 1
    best_G: int = 1
    per_sg: List[Tuple[int, int, float]] = field(default_factory=list)
    infeasible: bool = False
    n_swept: int = 0            # points actually swept (memo misses only)
    n_memo_hits: int = 0        # stage hypotheses served from the memo
    workers: int = 1            # sweep-executor worker processes used
    n_cache_hits: int = 0       # knob-tuple tape-cache hits (executor path)
    n_cache_misses: int = 0
    hosts_used: int = 0         # remote sweep daemons that served shards
    n_host_failures: int = 0    # shards that fell back to local execution
    n_store_hits: int = 0       # frontiers preloaded from the memo store
    from_memo: bool = False     # whole report served by the memo store


def _space_knobs(space: str, layers: int) -> Dict:
    """ckpt: "none" (no recompute), "full" (all layers, Megatron default),
    or "tune" (CKPT_i in the search space)."""
    full = dict(zeros=(0, 1, 2, 3), ratios=RATIO_GRID,
                ratio_dims=("oo", "ao"), ckpt="tune")
    if space == "none":      # parallelism only — Fig. 2(a)
        return dict(zeros=(0,), ratios=(0.0,), ratio_dims=(), ckpt="none")
    if space == "megatron":  # fixed FULL recompute + ZeRO-1
        return dict(zeros=(1,), ratios=(0.0,), ratio_dims=(), ckpt="full")
    if space == "ckpt":      # Aceso/AdaPipe: + CKPT tuning
        return dict(zeros=(1,), ratios=(0.0,), ratio_dims=(), ckpt="tune")
    if space == "zero":      # DeepSpeed: + ZeRO tuning (full recompute)
        return dict(zeros=(0, 1, 2, 3), ratios=(0.0,), ratio_dims=(),
                    ckpt="full")
    if space == "offload":   # + offload-ratio tuning
        return dict(zeros=(1,), ratios=RATIO_GRID, ratio_dims=("oo", "ao"),
                    ckpt="tune")
    if space in ("mist", "uniform"):
        return full
    raise ValueError(f"unknown space {space!r}; have {SPACES}")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item}, "
                               "ROADMAP.md)")


class MistTuner:
    def __init__(self, spec: TuneSpec, *, hw: HardwareSpec = H100,
                 cp: CostParams = CostParams()):
        if spec.backend not in BACKENDS:
            raise ValueError(f"unknown backend {spec.backend!r}; "
                             f"have {BACKENDS}")
        if spec.profile is not None:
            # fitted constants layered over cp; workers rebuilding from the
            # pickled spec apply the identical overrides (determinism)
            cp = spec.profile.cost_params(cp)
        if spec.hosts:
            raise _not_ported("the multi-host sweep (hosts)",
                              "queue A: core/remote.py and service/")
        self.spec, self.hw, self.cp = spec, hw, cp
        self._scm_cache: Dict[Tuple[bool, bool], StageCostModel] = {}
        # cross-(S, G) frontier memo: identical stage hypotheses (same
        # layers, devices, G, role, inflight, and search-space knobs) are
        # swept once and reused across the S/G double loop.
        self._frontier_memo: Dict[Tuple, IntraStageResult] = {}
        self._memo_hits = 0
        self._n_swept = 0
        self._kernel_grid: Optional[Tuple[Tuple[int, ...], ...]] = None

    # -- kernel-config grid (the tuned tile/block dimension) -----------------
    def kernel_grid(self) -> Tuple[Tuple[int, ...], ...]:
        """The (q_block, kv_block, rmsnorm_block, ssd_chunk) tuples swept
        jointly with every candidate.  Derived once per tuner from the spec
        (workers rebuild the tuner from the pickled spec, so every process
        computes the identical grid)."""
        if self._kernel_grid is None:
            if self.spec.kernel_grid is not None:
                self._kernel_grid = tuple(
                    tuple(int(x) for x in t) for t in self.spec.kernel_grid)
            elif self.spec.kernel_tune:
                from repro_torch.kernels.autotune import legal_kernel_grid
                self._kernel_grid = legal_kernel_grid(
                    self.spec.arch, seq_len=self.spec.seq_len, hw=self.hw,
                    cp=self.cp)
            else:
                self._kernel_grid = DEFAULT_KERNEL_GRID
        return self._kernel_grid

    # -- stage cost model per role (L / inflight are symbols -> reusable) ---
    def scm(self, has_embed: bool, has_head: bool) -> StageCostModel:
        key = (has_embed, has_head)
        if key not in self._scm_cache:
            # self.cp already carries the profile's CostParams overrides
            # (applied in __init__, so sweep workers see them too); passing
            # the profile again is idempotent — the overrides are absolute
            # values — and also applies its interference table and
            # torch_auto_threshold pin
            self._scm_cache[key] = StageCostModel(
                self.spec.arch, self.spec.seq_len, hw=self.hw, cp=self.cp,
                has_embed=has_embed, has_head=has_head,
                backend=self.spec.backend, device=self.spec.device,
                profile=self.spec.profile)
        return self._scm_cache[key]

    def stage_counts(self) -> List[int]:
        if self.spec.stage_counts is not None:
            return list(self.spec.stage_counts)
        N, L = self.spec.n_devices, self.spec.arch.num_layers
        out = []
        s = 1
        while s <= min(N, L, 16):
            if N % s == 0:
                out.append(s)
            s *= 2
        return out

    def grad_accums(self) -> List[int]:
        if self.spec.grad_accums is not None:
            return list(self.spec.grad_accums)
        gs = grad_accum_choices(self.spec.global_batch, self.spec.n_devices)
        # keep the sweep tractable: log-spaced subset
        if len(gs) > 8:
            idx = np.unique(np.geomspace(1, len(gs), 8).astype(int) - 1)
            gs = [gs[i] for i in idx]
        return gs

    # -- per-(S, G) candidate construction -----------------------------------
    def _layer_options(self, S: int) -> List[int]:
        L = self.spec.arch.num_layers
        base = L // S
        w = self.spec.layer_window if S > 1 else 0
        opts = sorted({max(1, base + k) for k in range(-w, w + 2)})
        return [l for l in opts if l <= L]

    def _memo_key(self, *, layers: int, n_dev: int, G: int, role, inflight,
                  knobs) -> Tuple:
        """Frontier-memo key; also the sweep executor's shard/merge key."""
        return (layers, n_dev, G, role, float(inflight),
                tuple(knobs["zeros"]), tuple(knobs["ratios"]),
                tuple(knobs["ratio_dims"]), knobs["ckpt"],
                self.kernel_grid())

    def _frontier(self, *, layers: int, n_dev: int, G: int, role, inflight,
                  knobs) -> IntraStageResult:
        key = self._memo_key(layers=layers, n_dev=n_dev, G=G, role=role,
                             inflight=inflight, knobs=knobs)
        if self.spec.engine != "legacy":
            hit = self._frontier_memo.get(key)
            if hit is not None:
                self._memo_hits += 1
                return hit
        has_embed, has_head = role
        res = tune_stage(
            self.spec.arch, seq_len=self.spec.seq_len, layers=layers,
            n_devices=n_dev, global_batch_per_stage=self.spec.global_batch,
            grad_accum=G, has_embed=has_embed, has_head=has_head,
            inflight=inflight, hw=self.hw, cp=self.cp,
            zeros=knobs["zeros"], ratios=knobs["ratios"],
            ratio_dims=knobs["ratio_dims"],
            ckpt_values={"tune": None, "full": (layers,),
                         "none": (0,)}[knobs["ckpt"]],
            max_tp=self.spec.max_tp, max_front=self.spec.max_front,
            scm=self.scm(has_embed, has_head),
            refine=bool(knobs["ratio_dims"]),
            engine=self.spec.engine,
            kernel_grid=self.kernel_grid())
        self._n_swept += res.n_evaluated
        if self.spec.engine != "legacy":
            self._frontier_memo[key] = res
        return res

    def _cands_for(self, S: int, G: int, knobs) -> List[List[StageCand]]:
        N = self.spec.n_devices
        n_dev = N // S
        out: List[List[StageCand]] = []
        self._n_points = getattr(self, "_n_points", 0)
        for i in range(S):
            role = (i == 0, i == S - 1)
            inflight = float(S - i)
            cs: List[StageCand] = []
            for l in self._layer_options(S):
                res = self._frontier(layers=l, n_dev=n_dev, G=G, role=role,
                                     inflight=inflight, knobs=knobs)
                self._n_points += res.n_evaluated
                for p in res.frontier:
                    d = p.d
                    t = p.t
                    if not self.spec.imbalance_aware:
                        # ablation: average the delta into t (what prior
                        # systems do), losing the imbalance term
                        t = t + d / max(G, 1)
                        d = 0.0
                    cs.append(StageCand(layers=l, n_devices=n_dev, t=t, d=d,
                                        point=p))
            out.append(cs)
        return out

    def _cells(self) -> List[Tuple[int, int]]:
        """The (S, G) hypothesis cells `tune` visits, in loop order."""
        return [(S, G)
                for S in self.stage_counts()
                for G in self.grad_accums()
                if not self.spec.global_batch % G]

    # -- main ----------------------------------------------------------------
    def _store(self):
        """The persistent memo store, or None (spec.memo_dir unset)."""
        if self.spec.memo_dir is None:
            return None
        if getattr(self, "_memo_store", None) is None:
            from repro_torch.core.memo_store import MemoStore
            self._memo_store = MemoStore(self.spec.memo_dir)
        return self._memo_store

    def tune(self) -> TuneReport:
        import dataclasses
        spec = self.spec
        t0 = time.time()
        store = self._store()
        if store is not None:
            # warm whole-query path: the report key ignores execution-
            # routing fields (engine/backend/device/workers/hosts), which never
            # change the answer, so any prior computation of this query
            # serves it — in milliseconds (docs/distributed-sweep.md)
            hit = store.load_report(self)
            if hit is not None:
                return dataclasses.replace(
                    hit, tune_seconds=time.time() - t0, from_memo=True)
        if spec.space == "serve":
            # inference regime: KV-cache memory + decode/prefill roofline
            # replace the training stage cost model entirely
            from repro_torch.core.serve_space import tune_serve
            rep = tune_serve(self)
            if store is not None:
                store.save_report(self, rep)
            return rep
        knobs = _space_knobs(spec.space, spec.arch.num_layers)
        best: Optional[Tuple[float, int, int, InterStageSolution]] = None
        per_sg = []
        n_milp = 0
        self._n_points = 0
        self._memo_hits = 0
        self._n_swept = 0
        sweep_stats = None
        n_store_hits = 0
        if spec.engine != "legacy" and spec.workers >= 1:
            # (S, G) sweep executor: G-collapsed hypothesis sweeps, run in
            # process (workers=1), across forked workers, or fanned out to
            # remote hosts, filling the frontier memo up front; the loop
            # below then runs entirely from the memo.  Plan-identical to
            # the plain loop by construction (see core/sweep.py;
            # tests/test_sweep.py, tests/test_distributed.py).
            from repro_torch.core.sweep import prefetch_frontiers
            cells = self._cells()
            if store is not None:
                # warm stage hypotheses load into the memo so plan_units
                # (inside prefetch_frontiers) drops them from the sweep
                n_store_hits = store.preload(self, cells, knobs)
            sweep_stats = prefetch_frontiers(self, cells, knobs,
                                             workers=spec.workers,
                                             hosts=spec.hosts)
            self._n_swept += sweep_stats.n_swept
            if store is not None:
                store.flush(self, cells, knobs)
        # gather each cell's candidate lists (all frontier-memo reads after
        # a prefetch), solve the independent per-cell MILPs, then reduce in
        # loop order, which keeps tie-breaking identical to the serial
        # engine.
        sols: Dict[Tuple[int, int], Optional[InterStageSolution]] = {}
        milp_jobs: List[Tuple[int, int, List[List[StageCand]]]] = []
        cells = self._cells()
        for S, G in cells:
            if spec.space == "uniform" and S > 1:
                sols[(S, G)] = self._solve_uniform(S, G, knobs)
            else:
                cands = self._cands_for(S, G, knobs)
                if any(not cs for cs in cands):
                    continue
                milp_jobs.append((S, G, cands))
        # (the reference solves them on the worker pool when it has one;
        # the port solves them here: HiGHS hangs in a child forked from a
        # process that has run it, core/sweep.py)
        n_milp += len(milp_jobs)
        for S, G, cands in milp_jobs:
            sols[(S, G)] = solve_milp(
                cands, total_layers=spec.arch.num_layers,
                total_devices=spec.n_devices, G=G)
        for S, G in cells:
            sol = sols.get((S, G))
            if sol is None:
                continue
            per_sg.append((S, G, sol.objective))
            if best is None or sol.objective < best[0]:
                best = (sol.objective, S, G, sol)
        dt = time.time() - t0
        workers_used = sweep_stats.workers_used if sweep_stats else 0
        c_hits = sweep_stats.cache_hits if sweep_stats else 0
        c_miss = sweep_stats.cache_misses if sweep_stats else 0
        hosts_used = sweep_stats.hosts_used if sweep_stats else 0
        host_fail = sweep_stats.n_host_failures if sweep_stats else 0
        if best is None:
            rep = TuneReport(plan=None, objective=float("inf"),
                             throughput_samples=0.0, throughput_tokens=0.0,
                             space=spec.space, n_points=self._n_points,
                             n_milp=n_milp, tune_seconds=dt,
                             infeasible=True, n_swept=self._n_swept,
                             n_memo_hits=self._memo_hits,
                             workers=workers_used, n_cache_hits=c_hits,
                             n_cache_misses=c_miss, hosts_used=hosts_used,
                             n_host_failures=host_fail,
                             n_store_hits=n_store_hits)
        else:
            obj, S, G, sol = best
            plan = self._to_plan(sol, G)
            rep = TuneReport(
                plan=plan, objective=obj,
                throughput_samples=spec.global_batch / obj,
                throughput_tokens=spec.global_batch * spec.seq_len / obj,
                space=spec.space, n_points=self._n_points, n_milp=n_milp,
                tune_seconds=dt, best_S=S, best_G=G, per_sg=per_sg,
                n_swept=self._n_swept, n_memo_hits=self._memo_hits,
                workers=workers_used, n_cache_hits=c_hits,
                n_cache_misses=c_miss, hosts_used=hosts_used,
                n_host_failures=host_fail, n_store_hits=n_store_hits)
        if store is not None:
            # an infeasible answer is still an answer: cache it too
            store.save_report(self, rep)
        return rep

    def _solve_uniform(self, S: int, G: int, knobs
                       ) -> Optional[InterStageSolution]:
        """Yuan et al.-style heuristic: identical config on every stage."""
        spec = self.spec
        L, N = spec.arch.num_layers, spec.n_devices
        if L % S or N % S:
            return None
        res = self._frontier(layers=L // S, n_dev=N // S, G=G,
                             role=(True, True), inflight=float(S),
                             knobs=knobs)
        self._n_points += res.n_evaluated
        if not res.frontier:
            return None
        best = None
        for p in res.frontier:
            sel = [StageCand(layers=L // S, n_devices=N // S, t=p.t, d=p.d,
                             point=p)] * S
            obj = pipeline_objective([p.t] * S, [p.d] * S, G)
            if best is None or obj < best.objective:
                best = InterStageSolution(objective=obj, selection=sel,
                                          status="uniform")
        return best

    def _to_plan(self, sol: InterStageSolution, G: int) -> Plan:
        stages = []
        for c in sol.selection:
            p = c.point
            assert p is not None
            stages.append(p.cand.to_stage(c.layers))
        plan = Plan(grad_accum=G, stages=tuple(stages),
                    sequence_parallel=True, remat_policy="full")
        # kernel dimension: the plan records stage 0's tile tuple (the
        # KernelConfig is plan-global; single-stage cells — the benchmarked
        # path — make this exact).  Emitted only when the sweep actually
        # moved off the default so frozen-default runs stay byte-identical;
        # a non-default choice switches execution onto the kernels the
        # tiles parameterize.  At the default, attn_impl stays "naive"
        # although the activation term prices flash attention (the
        # reference's behaviour, kept for parity; ROADMAP.md §C).
        kc = sol.selection[0].point.cand.kernel_config()
        if kc != DEFAULT_KERNEL_CONFIG:
            plan = plan.replace(kernel=kc, attn_impl="pallas",
                                use_pallas=True)
        return plan


# ---------------------------------------------------------------------------
# convenience
# ---------------------------------------------------------------------------


def tune(arch: ArchConfig, shape: ShapeConfig, n_devices: int,
         space: str = "mist", *, hw: HardwareSpec = H100,
         cp: CostParams = CostParams(), **kw) -> TuneReport:
    spec = TuneSpec(arch=arch, seq_len=shape.seq_len,
                    global_batch=shape.global_batch, n_devices=n_devices,
                    space=space, **kw)
    return MistTuner(spec, hw=hw, cp=cp).tune()
