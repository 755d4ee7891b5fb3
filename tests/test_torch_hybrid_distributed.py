"""Multi-device training of the PyTorch port's hybrid on the CPU, over gloo,
at reduced zamba2-2.7b (8 Mamba2 layers in 2 groups of 4, d 128, 16 SSD
heads of 16 with state 16 and one B/C group, a shared block of 4 heads of
32, d_ff 256, vocab 512) in f32, global batch 8 of 64 tokens, SSD chunk 16
(four chunks), two steps, every rank starting from its cut of the same
one-process state (seed 0).

The mixer's params are cut as the reference's spec tables cut them:
``in_proj`` on its fused 560 columns (140 a rank at tp 4, which are not
whole heads), the conv on its 288 channels, ``A_log`` / ``D`` /
``dt_bias`` on the heads, ``norm_scale`` and ``out_proj`` on d_inner;
``groups/in_proj`` stays whole.  Every case is held to the port's
one-process step on the same plan at dp = tp = 1 with the tolerances of
``tests/test_torch_distributed.py`` (loss 1e-5, grad norm 1e-4, params
and master within lr/2 and 1e-6 on average, mu and nu within MOMENT_RTOL
of their norm), every rank's ``init_sharded_state`` is its cut of the
one-process init bit for bit, and every rank's state bytes are the memory
report's exactly.  tp 4 SP and dp 2 x tp 2 are also held to the
reference's ``make_train_step`` on 1 x 4 and 2 x 2 meshes of forced host
devices (x64), both in one jax subprocess that runs beside the port's
worlds.

Two test conditions keep the model's own rounding out of the comparison:
the params are f64 (the model keeps its f32 internals), and Adam's eps is
1e-3.  This random-init hybrid's f32 gradients sit 2-3e-5 (relative norm)
from its f64 ones on one process, and the sums tp reorders land at the same
distance; at eps 1e-8 Adam's first update is lr times the gradient's sign,
so an element whose gradient lies within that noise of zero moves 2 lr one
way or the other, and the second step's mu and nu then differ by 1-2e-3 (tp
2 in f32).  With f64 params the noise is the f32 internals' (~1.4e-6), and
eps 1e-3 makes the first update continuous in the gradient.  A gradient
that is wrong still shows in mu and nu: the gated norm's sum of squares
taken through the reduce-from-tp Function (identity backward) moves mu of
``norm_scale`` and ``in_proj`` by 69% and 88% at tp 2.

The ranks of each world size (2 and 4) are processes started together, as
in ``tests/test_torch_distributed.py``, whose helpers this module uses.
The world of 2 also writes its tp 2 SP state as a checkpoint, which one
process restores bit for bit, and restores the one-process checkpoint the
test process wrote at tp 2 SP, bit for bit.
"""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_distributed as TD
from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.plan import KernelConfig, Plan, StageConfig, \
    single_stage_plan
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import init_distributed, make_plan_mesh
from repro_torch.lowering import lower_plan, plan_mesh
from repro_torch.models import common as TC
from repro_torch.models.zoo import build_model
from repro_torch.training import optimizer as TOPT
from repro_torch.training import step as TSTEP
from repro_torch.training.checkpoint import Checkpointer, StatePlacement

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "zamba2-2.7b"
HCFG = get_arch(ARCH).reduced()
GBS, SEQ, STEPS = TD.GBS, TD.SEQ, TD.STEPS
# the test conditions that keep the model's own rounding noise out of the
# comparison (module docstring): params in f64, Adam's eps at 1e-3
DTYPE = torch.float64
ADAM = TOPT.AdamConfig(eps=1e-3)

# name -> (dp, tp, single_stage_plan knobs)
CASES = {
    "tp2_sp": (1, 2, dict(zero=1, sequence_parallel=True)),
    "tp2_no_sp": (1, 2, dict(zero=1, sequence_parallel=False)),
    "dp2_z3_ckpt_ao": (2, 1, dict(zero=3, ckpt_layers=4, ao=0.5)),
    "tp4_sp": (1, 4, dict(zero=1, sequence_parallel=True)),
    "dp2_tp2_z2_wo_oo": (2, 2, dict(zero=2, wo=0.5, oo=0.5,
                                    sequence_parallel=True)),
}
# held to the reference's mesh too
REFERENCE_CASES = ("tp4_sp", "dp2_tp2_z2_wo_oo")


def _plan(dp, tp, knobs) -> Plan:
    knobs = {"ckpt_layers": 0, **knobs}
    return single_stage_plan(HCFG.num_layers, dp=dp, tp=tp,
                             micro_batch=GBS // (2 * dp), grad_accum=2,
                             attn_impl="blocked",
                             kernel=KernelConfig(ssd_chunk=16), **knobs)


def _one_plan(plan: Plan) -> Plan:
    """``plan`` at dp = tp = 1: the same global micro-batches."""
    st = plan.stages[0]
    return plan.replace(stages=(st.replace(
        dp=1, tp=1, micro_batch=st.micro_batch * st.dp),))


def _f32_place(plan, mesh):
    return StatePlacement(HCFG, plan, mesh, "cpu", param_dtype=torch.float32)


def _checkpoints(plan, mesh, state, ckdir: pathlib.Path):
    """The tp 2 SP case's checkpoints, both ways: its trained state written
    (rank 0 writes the gathered state), and the one-process checkpoint of
    ``ckdir / "one"`` restored at tp 2 SP and gathered back whole."""
    place = _f32_place(plan, mesh)
    Checkpointer(ckdir / "tp2_sp").save(STEPS, state, {"arch": HCFG.name},
                                        place=place)
    _, live, _ = Checkpointer(ckdir / "one").restore(place=place)
    return bridge.gather_train_state(live, HCFG, plan, mesh, keep_dtype=True)


def _rank_main(out: str, ckdir: str) -> None:
    """One rank of a world: every case of its size; rank 0 pickles each
    case's metrics, gathered final state and its checks of every rank."""
    rank, world, _ = init_distributed("cpu")
    results = {}
    try:
        for name, (dp, tp, knobs) in CASES.items():
            if dp * tp != world:
                continue
            plan = _plan(dp, tp, knobs)
            mesh = make_plan_mesh(dp, tp, "cpu")
            init_ok = torch.tensor(float(
                TD._init_is_the_cut_of_one_process(HCFG, plan, mesh)))
            dist.all_reduce(init_ok, op=dist.ReduceOp.MIN)
            before = TC.OFFLOADED_BYTES
            metrics, state, grads, _ = TD._train(HCFG, plan, mesh, DTYPE,
                                                 ADAM)
            offloaded = TC.OFFLOADED_BYTES - before
            full = bridge.gather_train_state(state, HCFG, plan, mesh)
            report = lower_plan(HCFG, ShapeConfig("t", SEQ, GBS, "train"),
                                plan, plan_mesh(plan)).memory_report()
            local = TD._state_bytes(state, grads)
            spread = torch.tensor([local, -local], dtype=torch.float64)
            dist.all_reduce(spread, op=dist.ReduceOp.MAX)
            restored = _checkpoints(plan, mesh, state, pathlib.Path(ckdir)) \
                if name == "tp2_sp" else None
            if rank == 0:
                results[name] = dict(
                    metrics=metrics, state=full, init_ok=bool(init_ok),
                    offloaded=offloaded, restored=restored,
                    local_bytes=(float(spread[0]), -float(spread[1])),
                    report_bytes=report.stages[0].state_bytes)
    finally:
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()


def _start_world(world: int, out: pathlib.Path, ckdir: pathlib.Path):
    port = train_launch._free_port()
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT / 'tests')!r}]; "
            "import test_torch_hybrid_distributed as T; "
            f"T._rank_main({str(out)!r}, {str(ckdir)!r})")
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
jax.config.update("jax_enable_x64", True)    # the port's f64 params
cfg = get_arch('zamba2-2.7b').reduced()
results = {}
for name, plan_json in inp["plans"].items():
    plan = Plan.from_json(plan_json)
    st = plan.stages[0]
    mesh = compat.make_mesh((st.dp, st.tp), ('data', 'model'))
    with compat.set_mesh(mesh):
        low = lower_plan(cfg, None, plan, mesh)
        st = low.stages[0]
        low = dataclasses.replace(low, stages=(dataclasses.replace(
            st, exec_cfg=st.exec_cfg.replace(compute_dtype=jnp.float64)),))
        step = make_train_step(build_model(cfg), plan, mesh,
                               OPT.AdamConfig(eps=inp["eps"]), donate=False,
                               lowered=low)
        params = {n: jnp.asarray(v) for n, v in inp["params"].items()}
        state = jax.device_put(OPT.init_state(params, low.axes_table,
                                              plan.stages[0]),
                               low.state_shardings())
        metrics = []
        for b in inp["batches"]:
            state, m = step.fn(state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        results[name] = {"metrics": metrics,
                         "state": jax.tree.map(np.asarray, state)}
with open(out, "wb") as f:
    pickle.dump(results, f)
"""


def _start_reference(tmp: pathlib.Path):
    """The reference's mesh runs of REFERENCE_CASES, from the port's initial
    weights and batches, in one jax subprocess of 4 forced host devices."""
    params, _ = build_model(HCFG, "cpu").init(
        torch.Generator().manual_seed(0), DTYPE)
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump({"plans": {n: _plan(*CASES[n]).to_json()
                               for n in REFERENCE_CASES},
                     "params": bridge.params_to_numpy(params),
                     "eps": ADAM.eps,
                     "batches": [{k: v.numpy() for k, v in b.items()}
                                 for b in TD._batches(HCFG)]}, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE_MESH, str(tmp / "ref_in.pkl"),
         str(tmp / "ref_out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _one_process_checkpoint(ckdir: pathlib.Path):
    """The one-process f32 state after one step of the tp 2 SP case's plan
    at dp = tp = 1, written as a checkpoint; returns its leaves."""
    plan = _one_plan(_plan(*CASES["tp2_sp"]))
    model = build_model(HCFG, "cpu")
    state = TOPT.init_state(*model.init(torch.Generator().manual_seed(0),
                                        torch.float32), plan.stages[0])
    state, _ = TSTEP.make_train_step(model, plan).fn(
        state, TD._batches(HCFG)[0])
    Checkpointer(ckdir / "one").save(1, state, {"arch": HCFG.name})
    return bridge.train_state_to_numpy(state)


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
    """Rank 0's results of every case (both world sizes started at once),
    the reference's mesh runs (started beside them), and the one-process
    checkpoint the world of 2 restored."""
    tmp = tmp_path_factory.mktemp("hybrid_dist")
    one_ckpt = _one_process_checkpoint(tmp / "ck")
    worlds = {w: _start_world(w, tmp / f"ws{w}.pkl", tmp / "ck")
              for w in (2, 4)}
    ref = _start_reference(tmp)
    results = {}
    for w, procs in worlds.items():
        _collect(procs, f"world of {w}")
        with open(tmp / f"ws{w}.pkl", "rb") as f:
            results.update(pickle.load(f))
    _collect([ref], "the reference's mesh runs")
    with open(tmp / "ref_out.pkl", "rb") as f:
        reference = pickle.load(f)
    return dict(results=results, reference=reference, ckdir=tmp / "ck",
                one_ckpt=one_ckpt)


def _one_process(plan):
    metrics, state, _, _ = TD._train(HCFG, _one_plan(plan), dtype=DTYPE,
                                     adam=ADAM)
    return metrics, bridge.train_state_to_numpy(state)


@pytest.mark.parametrize("case", list(CASES))
def test_hybrid_multi_device_step_matches_one_process(runs, case):
    """Every rank's ``init_sharded_state`` is its cut of the one-process
    init; loss, grad norm, params, master, mu and nu after two steps,
    gathered whole, against the one-process step; each rank's state is
    exactly the bytes the memory report charges per device; the AO hook
    took each offloading group's input, this rank's part of it."""
    got = runs["results"][case]
    assert got["init_ok"], case
    dp, tp, knobs = CASES[case]
    plan = _plan(dp, tp, knobs)
    TD._hold(got["metrics"], got["state"], *_one_process(plan))
    assert got["local_bytes"] == (got["report_bytes"],) * 2, case
    st, per = plan.stages[0], HCFG.shared_attn_every
    groups = -(-int(round(st.ao * min(st.ckpt_layers, st.layers))) // per)
    seq = SEQ // tp if plan.sequence_parallel and tp > 1 else SEQ
    assert got["offloaded"] == STEPS * plan.grad_accum * groups * \
        st.micro_batch * seq * HCFG.d_model * DTYPE.itemsize, case


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_hybrid_multi_device_step_matches_the_reference_mesh(runs, case):
    """tp 4 SP on a 1 x 4 mesh and dp 2 x tp 2 ZeRO 2 (WO = OO = 0.5) on a
    2 x 2 mesh of the reference (x64, the same Adam), from the same
    weights and batches: loss, grad norm, params, master, mu and nu after
    two steps."""
    ref = runs["reference"][case]
    got = runs["results"][case]
    TD._hold(got["metrics"], got["state"], ref["metrics"], ref["state"])


def _bitwise(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _bitwise(got[k], want[k], f"{what}/{k}")
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def test_tp2_sp_checkpoint_restores_on_one_process_bit_for_bit(runs):
    """The tp 2 SP state after two steps, written by its ranks (rank 0
    writes the gathered state), restores on one process (a dp = tp = 1
    placement) leaf for leaf bit for bit; and the one-process checkpoint,
    restored at tp 2 SP and gathered back, is the checkpoint bit for
    bit."""
    plan = _one_plan(_plan(*CASES["tp2_sp"]))
    _, state, manifest = Checkpointer(runs["ckdir"] / "tp2_sp").restore(
        place=_f32_place(plan, None))
    assert manifest["world"] == 2
    _bitwise(bridge.train_state_to_numpy(state),
             runs["results"]["tp2_sp"]["state"], "tp2_sp -> one")
    back = runs["results"]["tp2_sp"]["restored"]
    for e in ("params", "master", "mu", "nu"):
        _bitwise(back[e], runs["one_ckpt"][e], f"one -> tp2_sp: {e}")


def test_a_pipelined_hybrid_plan_raises_before_any_step():
    """S = 2 for the hybrid: the rank's state and its plan (which the
    pipeline's step builds first) refuse it, naming the reference's
    PIPELINE_FAMILIES, before any rank draws a param."""
    plan = Plan(grad_accum=2, attn_impl="blocked", stages=tuple(
        StageConfig(layers=4, micro_batch=4, dp=1, tp=1, zero=1,
                    ckpt_layers=0) for _ in range(2)))
    model = build_model(HCFG, "cpu")
    for call in (lambda: TSTEP.init_sharded_state(
                     model, plan, None, torch.Generator()),
                 lambda: TSTEP.rank_plan(model, plan, None)):
        with pytest.raises(NotImplementedError, match="PIPELINE_FAMILIES"):
            call()
    with pytest.raises(NotImplementedError, match="no pipeline"):
        model.init(torch.Generator(), layers=(0, 4))


def test_launcher_trains_a_dp2_tp2_zero3_hybrid_plan_on_four_ranks(
        tmp_path, capfd):
    """``train --arch zamba2-2.7b --smoke --nproc 4 --plan-json`` (dp 2 x
    tp 2, ZeRO 3, SP) trains and prints its losses."""
    plan = single_stage_plan(HCFG.num_layers, dp=2, tp=2, micro_batch=2,
                             grad_accum=2, zero=3, ckpt_layers=4,
                             attn_impl="pallas", use_pallas=True)
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    assert train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--steps", "2", "--plan-json", str(path),
                              "--nproc", "4"]) == 0
    out = capfd.readouterr().out
    losses = [float(x) for x in
              out.split("# losses: ")[1].splitlines()[0].split()]
    assert len(losses) == 2 and np.all(np.isfinite(losses)), out
