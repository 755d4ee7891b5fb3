"""The Plan -> LoweredPlan pass (the port of ``repro/lowering/lower.py``).

Two halves, as in the reference, of which the port has the first and
guards the second:

* ``lower_plan(cfg, shape, plan, mesh)`` computes pure metadata over a
  mesh: per-stage mesh-axis roles (with the tp = 1 fold), the ExecConfigs
  and the pipeline roles.  The mesh may be an ``AbstractMesh``
  (``repro_torch.parallel.sharding``), so it lowers multi-device and
  pipelined plans for the memory report (``lowering/memory.py``) without
  running them, or a live ``DeviceMesh``.  ``check_plan_mesh`` rejects a
  mesh whose axis sizes disagree with the plan.  ``LoweredPlan``'s spec
  tables (``param_specs``, ``grad_specs``, ``opt_specs``, ``state_specs``)
  map every param of the config to the mesh axes its dims are split over,
  the counterparts of the reference's ``param_shardings`` /
  ``grad_shardings`` / ``state_shardings``; ``shard_tensor`` cuts one
  rank's part of a full tensor by a spec.  Each stage of a pipelined plan
  has its own tables: the params it holds (its own stacked layers, and
  the embedding, head and final norm on the first and last stage only,
  as ``state_layout.state_terms`` charges them) at its own layer count,
  and its own layer range of the whole stack (``LoweredStage.layers``).

* Execution: training runs S stages on exactly S · dp · tp ranks, every
  stage with the same (dp, tp) (``check_train_plan``); serving one stage
  on exactly dp · tp ranks (``check_serve_plan``), its caches placed by
  ``LoweredPlan.cache_specs`` (the reference's ``cache_shardings``).
  ``train_exec_cfg`` and ``serve_exec_cfg`` apply them before they hand
  the single-stage step builders their ExecConfig;
  ``parallel/pipeline.py`` takes each stage's own ``exec_cfg``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.plan import Plan, StageConfig
from repro_torch.lowering.state_layout import param_class
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
    # this stage's range [start, stop) of the whole layer stack
    layers: Tuple[int, int] = (0, 0)

    def holds(self, name: str, axes) -> bool:
        """Whether this stage holds the param: every stage its stacked
        layers (and a shared block), the first and last stage the
        embedding, the head and the final norm."""
        return param_class(name, axes) != "embed" or \
            self.has_embed or self.has_head


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

    # -- spec tables (execution) ---------------------------------------------

    def shard_rules(self, i: int = 0) -> Dict[str, Optional[str]]:
        return SH.make_shard_rules(self.mesh, self.stages[i].mesh_axes,
                                   self.plan.sequence_parallel)

    def stage_cfg(self, i: int = 0) -> ArchConfig:
        """The config of stage ``i``'s program: its own layer count."""
        if len(self.stages) == 1:
            return self.cfg
        return self.cfg.replace(num_layers=self.stages[i].stage.layers)

    def stage_params(self, i: int = 0):
        """(params, axes) on the meta device of what stage ``i`` holds,
        at its own layer count."""
        from repro_torch.core.costmodel_params import meta_params
        params, axes = meta_params(self.stage_cfg(i))
        st = self.stages[i]
        return ({n: p for n, p in params.items() if st.holds(n, axes[n])},
                axes)

    def _spec_table(self, i: int, spec_fn, zero_kw: str) -> Dict[str, Any]:
        params, axes = self.stage_params(i)
        st = self.stages[i]
        tp_size = SH.axis_size(self.mesh, st.mesh_axes.tp)
        ep_ok = self.cfg.num_experts > 0 and \
            self.cfg.num_experts % max(1, tp_size) == 0
        zero = st.stage.zero
        kw = {"zero3": zero >= 3} if zero_kw == "zero3" else {"zero": zero}
        return {n: spec_fn(n, tuple(p.shape), axes[n], self.mesh,
                           st.mesh_axes, ep_ok=ep_ok, **kw)
                for n, p in params.items()}

    def param_specs(self, i: int = 0) -> Dict[str, SH.Spec]:
        """bf16 weights: tp, and fsdp at ZeRO 3."""
        return self._spec_table(i, SH.param_spec, "zero3")

    def grad_specs(self, i: int = 0) -> Dict[str, SH.Spec]:
        """The f32 gradient accumulator: tp, and fsdp at ZeRO >= 2."""
        return self._spec_table(i, SH.grad_spec, "zero")

    def opt_specs(self, i: int = 0) -> Dict[str, SH.Spec]:
        """f32 master / mu / nu: tp, and fsdp at ZeRO >= 1."""
        return self._spec_table(i, SH.opt_spec, "zero")

    def state_specs(self, i: int = 0) -> Dict[str, Any]:
        """Specs mirroring the train-state tree: params by
        ``param_specs``, master/mu/nu by ``opt_specs``, a WO/OO-split leaf
        as ``{"host", "dev"}`` with the same spec (the split cuts the
        leading layer dim, which is never sharded)."""
        from repro_torch.training.optimizer import split_k
        params, axes = self.stage_params(i)
        st = self.stages[i].stage
        ospecs = self.opt_specs(i)

        def entry(ratio):
            return {n: ({"host": sp, "dev": sp}
                        if split_k(n, params[n].shape, axes, ratio) else sp)
                    for n, sp in ospecs.items()}

        return {"step": (), "params": self.param_specs(i),
                "master": entry(st.wo), "mu": entry(st.oo),
                "nu": entry(st.oo)}

    def cache_specs(self, caches, batch: int, i: int = 0,
                    batch_dims=None) -> Tuple[Dict[str, Any], str]:
        """(the spec tree of the cache tree ``caches``, the cache-update
        mode) for serving ``batch`` rows: the counterpart of the
        reference's ``cache_shardings`` (``sharding.cache_specs``, whose
        ``batch_dims`` it passes on, and ``sharding.cache_update_mode``)."""
        ma = self.stages[i].mesh_axes
        specs = SH.cache_specs(caches, self.mesh, ma, batch, batch_dims)
        return specs, SH.cache_update_mode(specs, ma)

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
    shape = SH.mesh_shape(mesh)
    has_stage = "stage" in shape
    if S > 1:
        if not has_stage:
            raise ValueError(
                f"plan/mesh mismatch: plan has {S} pipeline stages but the "
                f"mesh {shape} has no 'stage' axis")
        if shape["stage"] != S:
            raise ValueError(
                f"plan/mesh mismatch: plan has {S} pipeline stages but the "
                f"mesh 'stage' axis has size {shape['stage']}")
    elif has_stage and shape["stage"] != 1:
        raise ValueError(
            f"plan/mesh mismatch: single-stage plan on a mesh with a "
            f"'stage' axis of size {shape['stage']}")
    for i, st in enumerate(plan.stages):
        ma = (SH.MeshAxes.from_mesh(mesh) if S > 1
              else plan_mesh_axes(mesh, st.tp))
        dp_size = SH.axis_size(mesh, ma.dp)
        tp_size = SH.axis_size(mesh, ma.tp)
        if (dp_size, tp_size) != (st.dp, st.tp):
            raise ValueError(
                f"plan/mesh mismatch at stage {i}: plan wants (dp, tp) = "
                f"({st.dp}, {st.tp}) but mesh {shape} provides "
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
    stages, start = [], 0
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
            inflight=max(1, S - i), layers=(start, start + st.layers)))
        start += st.layers
    return LoweredPlan(cfg=cfg, shape=shape, plan=plan, mesh=mesh,
                       stages=tuple(stages))


# -- execution ----------------------------------------------------------------


def shard_tensor(x, spec, sizes: Mapping[str, int],
                 coords: Mapping[str, int]):
    """This rank's part of the full tensor (or numpy array) ``x``: each dim
    whose ``spec`` entry names a mesh axis is cut into that axis' size
    equal parts, and the part at the rank's coordinate on the axis is kept
    (a view)."""
    if len(spec) != len(x.shape):
        raise ValueError(f"spec {spec} for a tensor of shape "
                         f"{tuple(x.shape)}")
    idx = []
    for n, e in zip(x.shape, spec):
        if e is None:
            idx.append(slice(None))
            continue
        if not isinstance(e, str):
            raise ValueError(f"spec entry {e!r}: the runtime splits a dim "
                             "over one mesh axis")
        k = sizes[e]
        if n % k:
            raise ValueError(f"dim {n} does not split into {k} parts")
        w = n // k
        idx.append(slice(coords[e] * w, (coords[e] + 1) * w))
    return x[tuple(idx)]


def check_train_plan(plan: Plan, world_size: int = 1,
                     num_layers: Optional[int] = None) -> None:
    """Reject a training plan this port cannot execute on ``world_size``
    ranks: it runs S pipeline stages on exactly S · dp · tp ranks, every
    stage with the same (dp, tp), so that an activation passes between
    the ranks at the same (data, model) coordinates of two stages (the
    reference's executor asks the same, ``uniform_shards``); with
    ``num_layers``, the stages' layers must add up to it."""
    S, st = plan.num_stages, plan.stages[0]
    shards = {(s.dp, s.tp) for s in plan.stages}
    if len(shards) > 1:
        raise ValueError(
            f"plan's {S} stages differ in (dp, tp): {sorted(shards)}; the "
            "port runs a pipeline whose stages share one (dp, tp) (retune "
            "with --space uniform; ROADMAP.md, queue A: pipeline)")
    if num_layers is not None and plan.total_layers != num_layers:
        raise ValueError(
            f"plan's stages hold {plan.total_layers} layers; the model has "
            f"{num_layers} (ROADMAP.md, queue A: pipeline)")
    if S * st.dp * st.tp != world_size:
        what = (f"S · dp · tp = {S} x {st.dp} x {st.tp}" if S > 1 else
                f"dp · tp = {st.dp} x {st.tp}")
        raise ValueError(
            f"plan wants {what} = {S * st.dp * st.tp} ranks but the world "
            f"has {world_size}; run it on exactly that many ranks "
            "(launch/train.py --nproc, or torchrun) or retune it "
            "(ROADMAP.md, queue A: sharding on torch and pipeline)")


def check_serve_plan(plan: Plan, world_size: int = 1) -> None:
    """Reject a serving plan this port cannot execute on ``world_size``
    ranks: it serves one pipeline stage on exactly dp · tp ranks."""
    if plan.num_stages != 1:
        raise ValueError(f"plan has {plan.num_stages} pipeline stages; the "
                         "port serves single-stage plans only (ROADMAP.md, "
                         "queue A: pipeline)")
    st = plan.stages[0]
    if st.dp * st.tp != world_size:
        raise ValueError(
            f"serving plan wants dp · tp = {st.dp} x {st.tp} = "
            f"{st.dp * st.tp} ranks but the world has {world_size}; serve "
            "it on exactly that many ranks (launch/serve.py --nproc, or "
            "torchrun) or retune it (ROADMAP.md, queue A: serving)")


def train_exec_cfg(plan: Plan, world_size: int = 1) -> ExecConfig:
    """The training exec config of a single-stage plan: its CKPT/AO
    segmentation, remat policy and kernel choice (a pipelined plan runs
    through ``parallel/pipeline.py``, which takes each stage's own)."""
    check_train_plan(plan, world_size)
    if plan.num_stages != 1:
        raise ValueError(f"plan has {plan.num_stages} pipeline stages: "
                         "train it with parallel/pipeline.py "
                         "(make_pipeline_train_step)")
    return stage_exec_config(plan, plan.stages[0])


def serve_exec_cfg(plan: Plan, world_size: int = 1, par=None,
                   cache_update: str = "dus", kv_split=None,
                   zero3=None) -> ExecConfig:
    """The serving exec config of a single-stage plan on ``world_size``
    ranks (inference never remats or offloads activations), carrying the
    rank's ``Parallel`` (None on one device), the cache-update mode
    (``LoweredPlan.cache_specs``), the group that splits the KV sequence
    (``common.KVSplit``, None where none does) and the ZeRO-3 weight
    gathers (``common.WeightGather``)."""
    check_serve_plan(plan, world_size)
    return stage_exec_config(plan, plan.stages[0]).replace(
        remat_policy="none", ckpt_layers=0, offload_layers=0, par=par,
        cache_update=cache_update, kv_split=kv_split, zero3=zero3)
