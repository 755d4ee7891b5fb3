"""The Plan -> LoweredPlan pass (the port of ``repro/lowering/lower.py``).

Two halves, as in the reference, of which the port has the first and
guards the second:

* ``lower_plan(cfg, shape, plan, mesh)`` computes pure metadata over an
  ``AbstractMesh`` (``repro_torch.parallel.sharding``): per-stage mesh-axis
  roles (with the tp = 1 fold), the ExecConfigs and the pipeline roles.  It touches no device, so it lowers
  multi-device and pipelined plans for the memory report
  (``lowering/memory.py``) without running them.  ``check_plan_mesh``
  rejects a mesh whose axis sizes disagree with the plan.  The
  reference's PartitionSpec tables (``param_specs``, ``grad_specs``,
  ``opt_specs``, the pipeline specs), the parameter shapes they read and
  the integer WO/OO host splits wait for the multi-device slice
  (ROADMAP.md, queue A item 6); the memory report prices WO/OO through
  the state layout.

* Execution: the port runs one pipeline stage with dp = tp = 1 on one
  device.  ``check_single_device_plan`` rejects anything else;
  ``train_exec_cfg`` and ``serve_exec_cfg`` apply it before they hand the
  step builders their ExecConfig.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.plan import Plan, StageConfig
from repro_torch.models.common import ExecConfig
from repro_torch.parallel import sharding as SH


def plan_mesh_axes(mesh, tp_size: int) -> SH.MeshAxes:
    """Plan-aware mesh-axis mapping: a tp=1 plan folds the 'model' axis
    into DP/FSDP (which axes mean what is the plan's decision)."""
    ma = SH.MeshAxes.from_mesh(mesh)
    if tp_size == 1 and ma.tp is not None:
        dp = ma.dp + (ma.tp,)
        return SH.MeshAxes(dp=dp, tp=None, fsdp=dp)
    return ma


def stage_exec_config(plan: Plan, stage: StageConfig) -> ExecConfig:
    """CKPT_i/AO_i -> remat segmentation + kernel/attention selection."""
    ck = min(stage.ckpt_layers, stage.layers)
    kc = plan.kernel
    return ExecConfig(
        ckpt_layers=ck,
        offload_layers=int(round(stage.ao * ck)),
        remat_policy=plan.remat_policy,
        attn_impl=plan.attn_impl,
        use_pallas=plan.use_pallas,
        sequence_parallel=plan.sequence_parallel,
        attn_q_block=kc.attn_q_block,
        attn_kv_block=kc.attn_kv_block,
        rmsnorm_block=kc.rmsnorm_block,
        ssd_chunk=kc.ssd_chunk,
    )


@dataclass(frozen=True)
class LoweredStage:
    """Everything one pipeline stage means, as pure metadata."""
    index: int
    stage: StageConfig
    mesh_axes: SH.MeshAxes
    exec_cfg: ExecConfig                  # train-mode segmentation
    has_embed: bool = True
    has_head: bool = True
    # live microbatches at this stage's memory peak (1F1B: S - i)
    inflight: int = 1


@dataclass(frozen=True)
class LoweredPlan:
    """One plan, interpreted against one abstract mesh."""
    cfg: ArchConfig
    shape: Optional[ShapeConfig]
    plan: Plan
    mesh: Any
    stages: Tuple[LoweredStage, ...]

    # -- exec configs ---------------------------------------------------------

    @property
    def plan_exec_cfg(self) -> ExecConfig:
        """Plan-level knobs only (no per-stage remat clamp) — the pipeline
        embed/unembed path and other stage-agnostic compute."""
        kc = self.plan.kernel
        return ExecConfig(remat_policy=self.plan.remat_policy,
                          attn_impl=self.plan.attn_impl,
                          use_pallas=self.plan.use_pallas,
                          sequence_parallel=self.plan.sequence_parallel,
                          attn_q_block=kc.attn_q_block,
                          attn_kv_block=kc.attn_kv_block,
                          rmsnorm_block=kc.rmsnorm_block,
                          ssd_chunk=kc.ssd_chunk)

    @property
    def serve_exec_cfg(self) -> ExecConfig:
        """Inference never remats/offloads activations."""
        return self.stages[0].exec_cfg.replace(
            remat_policy="none", ckpt_layers=0, offload_layers=0)

    # -- memory ---------------------------------------------------------------

    def memory_report(self, **kw):
        from repro_torch.lowering.memory import memory_report
        return memory_report(self, **kw)

    def state_layout_terms(self, i: int = 0) -> Dict[str, float]:
        """Per-device state bytes of stage ``i`` by term — the shared
        state-layout derivation (``lowering/state_layout.py``) evaluated
        concretely against this lowering's mesh degrees; the same
        derivation the tuner's cost model evaluates symbolically."""
        from repro_torch.lowering.memory import stage_layout_terms
        return stage_layout_terms(self, i)


def check_plan_mesh(plan: Plan, mesh) -> None:
    """Reject lowering a plan onto a mesh whose axis sizes disagree with
    the plan's parallel degrees.  The intentional tp=1 fold
    (``plan_mesh_axes`` folds 'model' into DP) stays legal: the folded dp
    is compared."""
    S = plan.num_stages
    has_stage = "stage" in mesh.shape
    if S > 1:
        if not has_stage:
            raise ValueError(
                f"plan/mesh mismatch: plan has {S} pipeline stages but the "
                f"mesh {dict(mesh.shape)} has no 'stage' axis")
        if mesh.shape["stage"] != S:
            raise ValueError(
                f"plan/mesh mismatch: plan has {S} pipeline stages but the "
                f"mesh 'stage' axis has size {mesh.shape['stage']}")
    elif has_stage and mesh.shape["stage"] != 1:
        raise ValueError(
            f"plan/mesh mismatch: single-stage plan on a mesh with a "
            f"'stage' axis of size {mesh.shape['stage']}")
    for i, st in enumerate(plan.stages):
        ma = (SH.MeshAxes.from_mesh(mesh) if S > 1
              else plan_mesh_axes(mesh, st.tp))
        dp_size = SH.axis_size(mesh, ma.dp)
        tp_size = SH.axis_size(mesh, ma.tp)
        if (dp_size, tp_size) != (st.dp, st.tp):
            raise ValueError(
                f"plan/mesh mismatch at stage {i}: plan wants (dp, tp) = "
                f"({st.dp}, {st.tp}) but mesh {dict(mesh.shape)} provides "
                f"(dp, tp) = ({dp_size}, {tp_size}); reshape the mesh view "
                f"to match the plan (or retune the plan for this mesh)")


def plan_mesh(plan: Plan) -> SH.AbstractMesh:
    """The abstract mesh shaped exactly like the plan: (stage,) data,
    model."""
    st0 = plan.stages[0]
    if plan.num_stages > 1:
        return SH.abstract_mesh((plan.num_stages, st0.dp, st0.tp),
                                ("stage", "data", "model"))
    return SH.abstract_mesh((st0.dp, st0.tp), ("data", "model"))


def lower_plan(cfg: ArchConfig, shape: Optional[ShapeConfig], plan: Plan,
               mesh) -> LoweredPlan:
    """The plan-interpretation entry point (see module docstring).

    ``shape`` is the workload the plan was tuned for; it is carried for
    ``memory_report`` and may be None for callers that never ask for one.
    Raises ValueError when the mesh axis sizes disagree with the plan's
    parallel degrees (``check_plan_mesh``)."""
    check_plan_mesh(plan, mesh)
    S = plan.num_stages
    stages = []
    for i, st in enumerate(plan.stages):
        # pipeline stages live in one program whose 'data'/'model' axes
        # are fixed by the mesh; single-stage plans may fold a tp=1
        # 'model' axis into DP (plan_mesh_axes)
        ma = (SH.MeshAxes.from_mesh(mesh) if S > 1
              else plan_mesh_axes(mesh, st.tp))
        stages.append(LoweredStage(
            index=i, stage=st, mesh_axes=ma,
            exec_cfg=stage_exec_config(plan, st),
            has_embed=(i == 0), has_head=(i == S - 1),
            inflight=max(1, S - i)))
    return LoweredPlan(cfg=cfg, shape=shape, plan=plan, mesh=mesh,
                       stages=tuple(stages))


# -- execution ----------------------------------------------------------------


def check_single_device_plan(plan: Plan, world_size: int = 1) -> None:
    """Reject a plan this port cannot execute yet: it runs one pipeline
    stage with dp = tp = 1 on one device."""
    if world_size != 1:
        raise ValueError(f"the port runs on one device; world size "
                         f"{world_size} waits for the multi-device slice")
    if plan.num_stages != 1:
        raise ValueError(f"plan has {plan.num_stages} pipeline stages; the "
                         "port runs single-stage plans only")
    st = plan.stages[0]
    if (st.dp, st.tp) != (1, 1):
        raise ValueError(f"plan wants (dp, tp) = ({st.dp}, {st.tp}); the port "
                         "runs dp = tp = 1 only (multi-device slice pending)")


def train_exec_cfg(plan: Plan) -> ExecConfig:
    """The training exec config: the plan's CKPT/AO segmentation, remat
    policy and kernel choice for its one stage."""
    check_single_device_plan(plan)
    return stage_exec_config(plan, plan.stages[0])


def serve_exec_cfg(plan: Plan) -> ExecConfig:
    """Inference never remats/offloads activations."""
    check_single_device_plan(plan)
    return stage_exec_config(plan, plan.stages[0]).replace(
        remat_policy="none", ckpt_layers=0, offload_layers=0)
