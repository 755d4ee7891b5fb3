"""Per-device memory accounting of a lowered plan (the port of
``repro/lowering/memory.py``).

``memory_report(lowered)`` charges each train stage's model state by
evaluating the shared state-layout module (``lowering/state_layout.py``)
**concretely** — the same per-group shard counts, replication sets and
integer WO/OO host splits the symbolic cost model evaluates over the
tuner's knob symbols.  Activation / transient / logits terms reuse the
cost model's analytic per-arch coefficients (``arch_stats``) with the
lowering's integer remat/offload segmentation.  The predictor and the
report are two evaluations of one derivation, so they agree bitwise
wherever the plan and the mesh agree, and ``MEMORY_REL_TOL`` is a drift
guard.  Serving shapes go through the shared cache layout
(``lowering/cache_layout.py``) the same way.

``memory_consistency`` is the tuner -> runtime check for one concrete
(cfg, shape, plan): the cost model's predicted peak against the
lowering's, with a per-term breakdown (state / act / transient / logits)
so a regression is attributable.

The reference's ``_state_walk`` / ``stage_state_bytes`` and
``stage_cache_bytes`` — walks over the PartitionSpec tables, kept there
as independent oracles of the layouts — are not ported: the tests hold
this module against the reference's report, and hold each rank's shards
(cut by ``LoweredPlan``'s spec tables) to its state bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, TYPE_CHECKING

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.hardware import H100, HardwareSpec
from repro_torch.lowering.state_layout import concrete_state_terms
from repro_torch.parallel import sharding as SH

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.lowering.lower import LoweredPlan

# Tolerance of the predicted-vs-lowered cross-check.  With the shared
# state-layout and cache-layout derivations the two sides agree bitwise
# on matched plan/mesh pairs, so the guard is pure drift detection.  The
# reference's value.
MEMORY_REL_TOL = 0.01


@dataclass(frozen=True)
class StageMemory:
    """Per-device bytes of one lowered stage (train kind unless noted)."""
    index: int
    weight_bytes: float = 0.0        # bf16 weights
    grad_bytes: float = 0.0          # f32 grad accumulator
    master_bytes: float = 0.0        # f32 master weights (device part)
    opt_bytes: float = 0.0           # f32 mu+nu (device part)
    host_state_bytes: float = 0.0    # WO/OO slices living in host memory
    act_bytes: float = 0.0           # saved activations at peak
    host_act_bytes: float = 0.0      # AO-offloaded activation bytes
    cache_bytes: float = 0.0         # KV/state caches (serving)
    transient_bytes: float = 0.0     # working set + recompute scratch
    logits_bytes: float = 0.0
    reserved_bytes: float = 0.0      # runtime + fragmentation

    @property
    def state_bytes(self) -> float:
        return (self.weight_bytes + self.grad_bytes + self.master_bytes
                + self.opt_bytes)

    @property
    def device_bytes(self) -> float:
        return (self.state_bytes + self.act_bytes + self.cache_bytes
                + self.transient_bytes + self.logits_bytes
                + self.reserved_bytes)


@dataclass(frozen=True)
class MemoryReport:
    kind: str                        # train | prefill | decode
    stages: tuple
    budget_bytes: float

    @property
    def peak_bytes(self) -> float:
        return max(s.device_bytes for s in self.stages)

    @property
    def fits(self) -> bool:
        return self.peak_bytes <= self.budget_bytes

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "peak_bytes": self.peak_bytes,
            "budget_bytes": self.budget_bytes,
            "fits": self.fits,
            "per_stage": [{
                "stage": s.index,
                "state_bytes": s.state_bytes,
                "host_state_bytes": s.host_state_bytes,
                "act_bytes": s.act_bytes,
                "host_act_bytes": s.host_act_bytes,
                "cache_bytes": s.cache_bytes,
                "device_bytes": s.device_bytes,
            } for s in self.stages],
        }


def stage_layout_terms(lowered: "LoweredPlan", i: int = 0
                       ) -> Dict[str, float]:
    """The shared state layout evaluated concretely for one lowered
    stage: tp/fsdp degrees come from the stage's actual MeshAxes (so
    folded tp=1 meshes count the real mesh)."""
    st = lowered.stages[i]
    sc = st.stage
    return concrete_state_terms(
        lowered.cfg,
        tp_size=SH.axis_size(lowered.mesh, st.mesh_axes.tp),
        fsdp_size=SH.axis_size(lowered.mesh, st.mesh_axes.fsdp),
        zero=sc.zero, wo=sc.wo, oo=sc.oo, layers=sc.layers,
        total_layers=lowered.plan.total_layers,
        has_embed=st.has_embed, has_head=st.has_head)


def memory_report(lowered: "LoweredPlan", *, hw: HardwareSpec = H100,
                  cp=None) -> MemoryReport:
    """Per-device bytes of the lowered plan (module docstring): state via
    the shared layout, activations/transients via the cost model's
    analytic coefficients + the ExecConfig's integer segmentation."""
    from repro_torch.core.costmodel import CostParams, arch_stats
    cp = cp or CostParams()
    shape = lowered.shape
    if shape is None:
        raise ValueError("memory_report needs the workload shape; pass it "
                         "to lower_plan")
    cfg, plan = lowered.cfg, lowered.plan
    stt = arch_stats(cfg)
    budget = hw.hbm_bytes * cp.mem_headroom

    if shape.kind != "train":
        return _serve_report(lowered, stt, shape, budget, cp)

    stages: List[StageMemory] = []
    for st in lowered.stages:
        sc, ec = st.stage, st.exec_cfg
        state = stage_layout_terms(lowered, st.index)
        tok = sc.micro_batch * shape.seq_len
        sp_div = sc.tp if plan.sequence_parallel else 1
        act_full_l = 2.0 * stt.act_coef_full * stt.d_model * tok / sp_div
        act_ckpt_l = 2.0 * stt.act_coef_ckpt * stt.d_model * tok / sp_div
        ck, off = ec.ckpt_layers, ec.offload_layers
        act = st.inflight * ((ck - off) * act_ckpt_l
                             + (sc.layers - ck) * act_full_l)
        act_host = st.inflight * off * act_ckpt_l
        # transient working set, mirroring the symbolic model: one layer's
        # full intermediates during (re)compute, gathered ZeRO-3 params
        # for ~2 layers, bwd boundary grads, and the bwd recompute scratch
        trans = 2.0 * act_full_l + 2.0 * act_ckpt_l * st.inflight \
            + act_full_l
        if sc.zero >= 3:
            trans += 2.0 * (2.0 * stt.n_layer / sc.tp)
        logits = (2.0 * sc.micro_batch * min(512, shape.seq_len)
                  * stt.vocab * 4.0 / sc.tp) if st.has_head else 0.0
        stages.append(StageMemory(
            index=st.index, weight_bytes=state["weight"],
            grad_bytes=state["grad"], master_bytes=state["master"],
            opt_bytes=state["opt"], host_state_bytes=state["host"],
            act_bytes=act, host_act_bytes=act_host,
            transient_bytes=trans, logits_bytes=logits,
            reserved_bytes=cp.runtime_reserved))
    return MemoryReport(kind="train", stages=tuple(stages),
                        budget_bytes=budget)


def _serve_report(lowered: "LoweredPlan", stt, shape: ShapeConfig,
                  budget: float, cp) -> MemoryReport:
    """Serving: params-per-device via the shared state-layout derivation
    and cache-per-device via the shared cache layout (the same two
    evaluations the serve cost model runs over its Expr tapes), plus the
    transient/reserved envelope from ``CostParams``."""
    from repro_torch.lowering.cache_layout import (
        concrete_cache_bytes, concrete_paged_cache_bytes,
        prefill_transient_bytes)
    st = lowered.stages[0]
    sc = st.stage
    mesh = lowered.mesh
    weight = stage_layout_terms(lowered, 0)["weight"]
    cache = 0.0
    if shape.kind == "decode":
        dp_size = SH.axis_size(mesh, st.mesh_axes.dp)
        tp_size = SH.axis_size(mesh, st.mesh_axes.tp)
        page_size = int(lowered.plan.page_size)
        if page_size > 0:
            # paged serve plan: the continuous-batching engine's pool
            # layout (page pools + trash page + widened pos + block table)
            cache = concrete_paged_cache_bytes(
                lowered.cfg, shape.global_batch, shape.seq_len, page_size,
                lowered.plan.kv_cache_dtype, dp_size=dp_size,
                tp_size=tp_size)
        else:
            cache = concrete_cache_bytes(
                lowered.cfg, shape.global_batch, shape.seq_len,
                lowered.plan.kv_cache_dtype, dp_size=dp_size,
                tp_size=tp_size)
        trans = cp.serve_decode_transient
    else:   # prefill: a couple of layers' activations + logits headroom
        trans = prefill_transient_bytes(
            stt.act_coef_full, stt.d_model, float(shape.global_batch),
            float(shape.seq_len), float(max(1, sc.dp)),
            float(max(1, sc.tp)))
    stage = StageMemory(index=0, weight_bytes=weight, cache_bytes=cache,
                        transient_bytes=trans,
                        reserved_bytes=cp.runtime_reserved)
    return MemoryReport(kind=shape.kind, stages=(stage,),
                        budget_bytes=budget)


def memory_consistency(cfg: ArchConfig, shape: ShapeConfig, plan, *,
                       hw: HardwareSpec = H100) -> Dict[str, Any]:
    """Predicted (symbolic ``estimate_plan``) vs lowered
    (``memory_report``) per-device peak bytes for one concrete plan, on
    an abstract mesh shaped exactly like the plan: the cost model that
    selected the plan and the lowering that executes it must agree on
    what the plan costs.

    ``terms`` breaks the gap down per memory term at the lowered peak
    stage.  Per-term rel errors are normalized by the predicted total, so
    tiny terms cannot blow the ratio up."""
    from repro_torch.core.costmodel import estimate_plan
    from repro_torch.lowering.lower import lower_plan, plan_mesh

    est = estimate_plan(cfg, shape, plan, hw=hw)
    rep = lower_plan(cfg, shape, plan, plan_mesh(plan)).memory_report(hw=hw)
    predicted = float(est["mem_peak_max"])
    lowered_b = float(rep.peak_bytes)
    rel = abs(lowered_b - predicted) / max(predicted, 1.0)

    peak_i = max(range(len(rep.stages)),
                 key=lambda i: rep.stages[i].device_bytes)
    ps = rep.stages[peak_i]
    pt = est["mem_terms_per_stage"][peak_i]
    lowered_terms = {"state": ps.state_bytes, "act": ps.act_bytes,
                     "transient": ps.transient_bytes,
                     "logits": ps.logits_bytes,
                     "host_state": ps.host_state_bytes,
                     "host_act": ps.host_act_bytes}
    terms = {k: {"predicted": float(pt[k]), "lowered": float(v),
                 "rel_error": abs(v - pt[k]) / max(predicted, 1.0)}
             for k, v in lowered_terms.items()}
    return {
        "predicted_bytes": predicted,
        "lowered_bytes": lowered_b,
        "rel_error": rel,
        "within_tol": rel <= MEMORY_REL_TOL,
        "terms": terms,
        "peak_stage": peak_i,
        "predicted_per_stage": [float(x) for x in est["mem_per_stage"]],
        "lowered_per_stage": [s.device_bytes for s in rep.stages],
    }
