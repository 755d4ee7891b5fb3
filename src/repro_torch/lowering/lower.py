"""Plan -> exec config (the port of ``repro/lowering/lower.py``).

One device only for now: ``check_plan_mesh`` accepts a single-stage plan
with dp = tp = 1 and raises on anything else.  Meshes, placements and the
memory report wait for the multi-device slice.
"""
from __future__ import annotations

from repro_torch.core.plan import Plan, StageConfig
from repro_torch.models.common import ExecConfig


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


def check_plan_mesh(plan: Plan, world_size: int = 1) -> None:
    """Reject a plan this port cannot lay out yet: it runs one pipeline
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
    check_plan_mesh(plan)
    return stage_exec_config(plan, plan.stages[0])


def serve_exec_cfg(plan: Plan) -> ExecConfig:
    """Inference never remats/offloads activations."""
    check_plan_mesh(plan)
    return stage_exec_config(plan, plan.stages[0]).replace(
        remat_policy="none", ckpt_layers=0, offload_layers=0)
