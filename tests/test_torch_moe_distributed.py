"""Multi-device training of the PyTorch port's MoE on the CPU, over gloo, at
reduced qwen2-moe-a2.7b (4 layers, d 128, 4 heads of 32 with 4 KV heads
and QKV biases, 4 routed experts top-2 of width 64, one shared expert of
64, vocab 512) in f32, global batch 8 of 64 tokens in G = 2 micro-batches,
two steps, every rank starting from its cut of the same one-process state
(seed 0).

The cases: tp 2 with expert parallelism (2 experts a rank, the router's
columns split with them) without and with sequence parallelism; tp 4 SP at
6 experts, which tp does not divide, so the experts split along
``moe_d_ff`` (16 columns a rank); dp 2 x tp 2 at ZeRO 2 with CKPT 2, the
plan of the reference's ``SINGLE_STAGE_SPMD`` (``tests/
test_pipeline_multidev.py``), where one group of 256 tokens spans both
data ranks (each rank's slots offset by the other's counts); and two
pipeline stages of 2 layers, each adding its own aux loss.  Each case is
held to the port's one-process step on the same plan at dp = tp = S = 1
with the tolerances of ``tests/test_torch_distributed.py`` (loss 1e-5,
grad norm 1e-4, params and master within lr/2 and 1e-6 on average, mu and
nu leaf by leaf within MOMENT_RTOL of their norm: a routing gradient that
is summed over tp twice, or not at all, shows there); the single-stage
ones also check ``init_sharded_state`` against the cut of the one-process
init and the state bytes against the memory report.  dp 2 x tp 2 is also
held to the reference's ``make_train_step`` on a 2 x 2 mesh of forced host
devices, in a jax subprocess started beside the worlds.
"""
import os
import pathlib
import pickle
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

import test_torch_distributed as TD
from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.plan import Plan, StageConfig, single_stage_plan
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import init_distributed, make_plan_mesh
from repro_torch.lowering import lower_plan, plan_mesh
from repro_torch.models.zoo import build_model
from repro_torch.parallel.pipeline import make_pipeline_train_step
from repro_torch.training import optimizer as TOPT
from repro_torch.training import step as TSTEP

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2-moe-a2.7b"
MCFG = get_arch(ARCH).reduced()
GBS, SEQ, STEPS = TD.GBS, TD.SEQ, TD.STEPS

# name -> (dp, tp, single_stage_plan knobs, experts)
CASES = {
    "tp2_ep": (1, 2, dict(zero=1, sequence_parallel=False), 4),
    "tp2_ep_sp": (1, 2, dict(zero=1, sequence_parallel=True), 4),
    "tp4_sp_mlp": (1, 4, dict(zero=1, sequence_parallel=True), 6),
    # the reference's SINGLE_STAGE_SPMD plan
    "dp2_tp2_z2": (2, 2, dict(zero=2, ckpt_layers=2), 4),
}
REFERENCE_CASE = "dp2_tp2_z2"
# two stages of 2 layers, world 2
PIPE = Plan(grad_accum=2, attn_impl="blocked", stages=tuple(
    StageConfig(layers=2, micro_batch=GBS // 2, dp=1, tp=1, zero=1,
                ckpt_layers=0) for _ in range(2)))


def _cfg(experts):
    return MCFG.replace(num_experts=experts)


def _plan(dp, tp, knobs) -> Plan:
    knobs = {"ckpt_layers": 0, **knobs}
    return single_stage_plan(MCFG.num_layers, dp=dp, tp=tp,
                             micro_batch=GBS // (2 * dp), grad_accum=2,
                             attn_impl="blocked", **knobs)


def _pipeline():
    """The two-stage plan on this rank, from its cut of the one-process
    f32 state: (metrics, the state gathered whole on rank 0)."""
    mesh = make_plan_mesh(1, 1, "cpu", 2)
    model = build_model(MCFG, "cpu")
    one = TOPT.init_state(*model.init(torch.Generator().manual_seed(0),
                                      torch.float32), PIPE.stages[0])
    state = bridge.shard_train_state(bridge.train_state_to_numpy(one), MCFG,
                                     PIPE, mesh, param_dtype=torch.float32)
    step = make_pipeline_train_step(model, PIPE, mesh)
    metrics = []
    for b in TD._batches(MCFG):
        state, m = step.fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, bridge.gather_train_state(state, MCFG, PIPE, mesh)


def _rank_main(out: str) -> None:
    """One rank of a world: every case of its size; rank 0 pickles each
    case's metrics, gathered final state and its checks of every rank."""
    rank, world, _ = init_distributed("cpu")
    results = {}
    try:
        for name, (dp, tp, knobs, experts) in CASES.items():
            if dp * tp != world:
                continue
            cfg, plan = _cfg(experts), _plan(dp, tp, knobs)
            mesh = make_plan_mesh(dp, tp, "cpu")
            init_ok = torch.tensor(float(
                TD._init_is_the_cut_of_one_process(cfg, plan, mesh)))
            dist.all_reduce(init_ok, op=dist.ReduceOp.MIN)
            metrics, state, grads, _ = TD._train(cfg, plan, mesh)
            full = bridge.gather_train_state(state, cfg, plan, mesh)
            report = lower_plan(cfg, ShapeConfig("t", SEQ, GBS, "train"),
                                plan, plan_mesh(plan)).memory_report()
            local = TD._state_bytes(state, grads)
            spread = torch.tensor([local, -local], dtype=torch.float64)
            dist.all_reduce(spread, op=dist.ReduceOp.MAX)
            if rank == 0:
                results[name] = dict(
                    metrics=metrics, state=full, init_ok=bool(init_ok),
                    local_bytes=(float(spread[0]), -float(spread[1])),
                    report_bytes=report.stages[0].state_bytes)
        if world == 2:
            metrics, full = _pipeline()
            if rank == 0:
                results["s2"] = dict(metrics=metrics, state=full)
    finally:
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()


def _start_world(world: int, out: pathlib.Path):
    port = train_launch._free_port()
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT / 'tests')!r}]; "
            "import test_torch_moe_distributed as T; "
            f"T._rank_main({str(out)!r})")
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


REFERENCE_MESH = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs.base import get_arch
from repro.core.plan import Plan
from repro.lowering import lower_plan
from repro.models.zoo import build_model
from repro.training import optimizer as OPT
from repro.training.step import make_train_step

src, out = sys.argv[1], sys.argv[2]
with open(src, "rb") as f:
    inp = pickle.load(f)
cfg = get_arch('qwen2-moe-a2.7b').reduced()
plan = Plan.from_json(inp["plan"])
st = plan.stages[0]
mesh = compat.make_mesh((st.dp, st.tp), ('data', 'model'))
with compat.set_mesh(mesh):
    low = lower_plan(cfg, None, plan, mesh)
    st = low.stages[0]
    low = dataclasses.replace(low, stages=(dataclasses.replace(
        st, exec_cfg=st.exec_cfg.replace(compute_dtype=jnp.float32)),))
    step = make_train_step(build_model(cfg), plan, mesh, donate=False,
                           lowered=low)
    params = {n: jnp.asarray(v) for n, v in inp["params"].items()}
    state = jax.device_put(OPT.init_state(params, low.axes_table,
                                          plan.stages[0]),
                           low.state_shardings())
    metrics = []
    for b in inp["batches"]:
        state, m = step.fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    state = jax.tree.map(np.asarray, state)
with open(out, "wb") as f:
    pickle.dump({"metrics": metrics, "state": state}, f)
"""


def _start_reference(tmp: pathlib.Path):
    """The reference's run of REFERENCE_CASE on its 2 x 2 mesh, from the
    port's initial weights and batches, in a jax subprocess."""
    dp, tp, knobs, _ = CASES[REFERENCE_CASE]
    params, _ = build_model(MCFG, "cpu").init(
        torch.Generator().manual_seed(0), torch.float32)
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump({"plan": _plan(dp, tp, knobs).to_json(),
                     "params": bridge.params_to_numpy(params),
                     "batches": [{k: v.numpy() for k, v in b.items()}
                                 for b in TD._batches(MCFG)]}, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={dp * tp}"}
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE_MESH, str(tmp / "ref_in.pkl"),
         str(tmp / "ref_out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _collect(procs, what):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    assert all(p.returncode == 0 for p in procs), \
        what + "\n" + "\n".join(logs)[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank 0's results of every case (both world sizes started at once)
    and the reference's mesh run, started beside them."""
    tmp = tmp_path_factory.mktemp("moe_dist")
    worlds = {w: _start_world(w, tmp / f"ws{w}.pkl") for w in (2, 4)}
    ref = _start_reference(tmp)
    results = {}
    for w, procs in worlds.items():
        _collect(procs, f"world of {w}")
        with open(tmp / f"ws{w}.pkl", "rb") as f:
            results.update(pickle.load(f))
    _collect([ref], "the reference's mesh run")
    with open(tmp / "ref_out.pkl", "rb") as f:
        reference = pickle.load(f)
    return dict(results=results, reference=reference)


def _one_process(cfg, plan):
    """The one-process run of ``plan``'s global micro-batches."""
    st = plan.stages[0]
    one = single_stage_plan(cfg.num_layers, dp=1, tp=1,
                            micro_batch=st.micro_batch * st.dp,
                            grad_accum=plan.grad_accum, attn_impl="blocked",
                            zero=st.zero, ckpt_layers=st.ckpt_layers)
    metrics, state, _, _ = TD._train(cfg, one)
    return metrics, bridge.train_state_to_numpy(state)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_multi_device_step_matches_one_process(runs, case):
    """Every rank's ``init_sharded_state`` is its cut of the one-process
    init; loss (the aux included), grad norm, params, master, mu and nu
    after two steps, gathered whole, against the one-process step; each
    rank's state is exactly the bytes the memory report charges."""
    got = runs["results"][case]
    assert got["init_ok"], case
    dp, tp, knobs, experts = CASES[case]
    TD._hold(got["metrics"], got["state"],
             *_one_process(_cfg(experts), _plan(dp, tp, knobs)))
    assert got["local_bytes"] == (got["report_bytes"],) * 2, case


def test_moe_dp2_tp2_zero2_matches_the_reference_mesh(runs):
    """The reference's SINGLE_STAGE_SPMD plan (dp 2 x tp 2, ZeRO 2, CKPT 2)
    on its 2 x 2 mesh, from the same weights and batches: loss, grad norm,
    params, master, mu and nu after two steps."""
    ref = runs["reference"]
    got = runs["results"][REFERENCE_CASE]
    TD._hold(got["metrics"], got["state"], ref["metrics"], ref["state"])


def test_moe_two_stage_pipeline_matches_one_process(runs):
    """S = 2, each stage adding the aux loss of its own layers: the loss
    every rank reports (the stages' aux terms included) and the state
    after two steps against one process."""
    got = runs["results"]["s2"]
    TD._hold(got["metrics"], got["state"], *_one_process(MCFG, PIPE))


def test_tp_that_splits_neither_experts_nor_their_width_raises():
    """tp 4 at 6 experts of width 66: neither dim divides, so the rank's
    plan raises before any param is drawn."""
    cfg = MCFG.replace(num_experts=6, moe_d_ff=66)
    with pytest.raises(NotImplementedError, match="experts 6 of 66"):
        TSTEP.rank_plan(build_model(cfg, "cpu"),
                        _plan(1, 4, dict(zero=1)), _FakeMesh())


class _FakeMesh:
    """A (data 1, model 4) mesh seen from rank 0, without a process
    group: ``rank_plan`` reads its shape, coordinates and groups."""
    mesh_dim_names, shape = ("data", "model"), (1, 4)

    def size(self, dim=None):
        return 4 if dim is None else self.shape[dim]

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0
