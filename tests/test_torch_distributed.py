"""Multi-device training of the PyTorch port on the CPU, over gloo, at reduced
granite-3-8b (4 layers, d 128, 4 heads, 1 KV head, d_ff 256, vocab 512) in
f32, global batch 8 of 64 tokens, two steps, every rank starting from its
cut of the same one-process state (seed 0).  Vocab 512 splits over tp 2 and
4, so the embedding and the head are vocab-parallel; the ``_v511`` cases
take vocab 511, which no tp divides (as granite-3-8b's 49155), so both stay
replicated and their gradients are summed over tp.

The ranks of each world size (2 and 4) are processes started together, as
``torchrun`` starts them (``RANK``/``WORLD_SIZE``/``MASTER_PORT``); they
run every case of their size, and rank 0 gathers each final state whole
(``bridge.gather_train_state``).  World size 1 runs in the test process.
Each case is held to the port's one-process step on the same plan at dp =
tp = 1 (``tests/test_torch_train.py`` holds that step to the reference),
with the train-step row of ``docs/port.md``: loss 1e-5 and grad norm 1e-4
relative; params and master within lr/2 elementwise and 1e-6 on average
(Adam divides each gradient by its own magnitude, so the ~1e-6 relative
difference of a sum taken in another order moves a near-zero gradient's
update by a visible share of lr); mu and nu, which are linear in the
gradients and their squares, leaf by leaf within MOMENT_RTOL of their own
norm, so a gradient summed twice or not at all shows even where Adam's
update hides it.  World size 1 is held bit for bit: it runs every
collective, on groups of one.  Two cases, dp 2 x tp 2 at ZeRO 2 and tp 4
with sequence parallelism at vocab 511, are also held to the reference's
own run on a mesh of forced host devices (weights and batches through
numpy), with the same tolerances.
"""
import functools
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.plan import Plan, single_stage_plan
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import init_distributed, make_plan_mesh
from repro_torch.lowering import lower_plan, plan_mesh
from repro_torch.lowering.state_layout import (choose_fsdp_dim,
                                               choose_tp_dim)
from repro_torch.models import common as TC
from repro_torch.models.zoo import build_model
from repro_torch.training import optimizer as TOPT
from repro_torch.training import step as TSTEP
from repro_torch.training.data import BatchSpec, SyntheticLM

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "granite-3-8b"
TCFG = get_arch(ARCH).reduced()
GBS, SEQ, STEPS = 8, 64, 2
ADAM = TOPT.AdamConfig()
LR = ADAM.lr
# mu and nu against the one-process step: the norm of the difference over
# the norm of the leaf, the grad norm's relative tolerance
MOMENT_RTOL = 1e-4
V = TCFG.vocab_size

# name -> (dp, tp, single_stage_plan knobs, vocab)
CASES = {
    "tp2_sp": (1, 2, dict(zero=1, sequence_parallel=True), V),
    "tp2_no_sp": (1, 2, dict(zero=1, sequence_parallel=False), V),
    "dp2_z0": (2, 1, dict(zero=0), V),
    "dp2_z1": (2, 1, dict(zero=1), V),
    "dp2_z2": (2, 1, dict(zero=2), V),
    "dp2_z3": (2, 1, dict(zero=3), V),
    "dp2_z1_wo_oo": (2, 1, dict(zero=1, wo=0.5, oo=0.5), V),
    "tp2_ckpt_ao": (1, 2, dict(zero=1, ckpt_layers=2, ao=0.5), V),
    "dp2_z3_ckpt_ao": (2, 1, dict(zero=3, ckpt_layers=2, ao=0.5), V),
    "dp2_z2_int8": (2, 1, dict(zero=2, grad_compression=True), V),
    "tp4_sp": (1, 4, dict(zero=1, sequence_parallel=True), V),
    "dp2_tp2_z2": (2, 2, dict(zero=2, ckpt_layers=2), V),
    # the embedding and the head replicated over tp
    "tp2_sp_v511": (1, 2, dict(zero=1, sequence_parallel=True), 511),
    "tp2_no_sp_v511": (1, 2, dict(zero=1, sequence_parallel=False), 511),
    "tp4_sp_v511": (1, 4, dict(zero=1, sequence_parallel=True), 511),
}


def _cfg(vocab):
    return TCFG.replace(vocab_size=vocab)


def _plan(dp, tp, knobs) -> Plan:
    knobs = {"ckpt_layers": 0, **knobs}
    return single_stage_plan(TCFG.num_layers, dp=dp, tp=tp,
                             micro_batch=GBS // (2 * dp), grad_accum=2,
                             attn_impl="blocked", **knobs)


def _batches(cfg):
    data = SyntheticLM(BatchSpec(global_batch=GBS, seq_len=SEQ,
                                 vocab_size=cfg.vocab_size))
    return [{k: torch.from_numpy(v) for k, v in data.batch(i).items()}
            for i in range(STEPS)]


def _train(cfg, plan, mesh=None, dtype=torch.float32, adam=ADAM):
    """(metrics per step, final state, the shapes of the grads adam_update
    was given, each grad's max |g| per step), from the one-process state
    of seed 0 with params in ``dtype`` (this rank's cut of it), Adam's
    ``adam``."""
    model = build_model(cfg, "cpu")
    state = TOPT.init_state(*model.init(torch.Generator().manual_seed(0),
                                        dtype), plan.stages[0])
    if mesh is not None:
        state = bridge.shard_train_state(bridge.train_state_to_numpy(state),
                                         cfg, plan, mesh, param_dtype=dtype)
    seen, amax = {}, {}
    real = TOPT.adam_update

    def spy(state, grads, *a):
        seen.update({n: tuple(g.shape) for n, g in grads.items()})
        for n, g in grads.items():
            amax.setdefault(n, []).append(float(g.abs().max()))
        return real(state, grads, *a)

    TOPT.adam_update = spy
    try:
        step = TSTEP.make_train_step(model, plan, adam, mesh=mesh)
        metrics = []
        for b in _batches(cfg):
            state, m = step.fn(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        TOPT.adam_update = real
    return metrics, state, seen, amax


def _state_bytes(state, grad_shapes) -> float:
    """What the memory report charges for this rank's state: bf16 weights,
    the f32 gradient sums, and the device parts of master and mu + nu."""
    def dev(v):
        return v["dev"] if isinstance(v, dict) else v

    n = 2.0 * sum(p.numel() for p in state["params"].values())
    n += 4.0 * sum(int(np.prod(s)) for s in grad_shapes.values())
    for e in ("master", "mu", "nu"):
        n += 4.0 * sum(dev(v).numel() for v in state[e].values())
    return n


def _leaves(state):
    for e in ("params", "master", "mu", "nu"):
        for n, v in state[e].items():
            yield from (v.values() if isinstance(v, dict) else (v,))


def _init_is_the_cut_of_one_process(cfg, plan, mesh) -> bool:
    """``init_sharded_state`` equals ``shard_train_state`` of the
    one-process initial state (bf16 params), leaf for leaf, bit for bit."""
    model = build_model(cfg, "cpu")
    full = bridge.train_state_to_numpy(TSTEP.init_train_state(
        model, plan, torch.Generator().manual_seed(0)))
    cut = bridge.shard_train_state(full, cfg, plan, mesh)
    mine = TSTEP.init_sharded_state(model, plan, mesh,
                                    torch.Generator().manual_seed(0))
    return all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(_leaves(cut), _leaves(mine)))


def _rank_main(out: str) -> None:
    """One rank of a world: every case of its size; rank 0 pickles each
    case's metrics, gathered final state and its checks of every rank."""
    rank, world, _ = init_distributed("cpu")
    results = {}
    try:
        for name, (dp, tp, knobs, vocab) in CASES.items():
            if dp * tp != world:
                continue
            cfg, plan = _cfg(vocab), _plan(dp, tp, knobs)
            mesh = make_plan_mesh(dp, tp, "cpu")
            init_ok = torch.tensor(float(
                _init_is_the_cut_of_one_process(cfg, plan, mesh)))
            dist.all_reduce(init_ok, op=dist.ReduceOp.MIN)
            before = TC.OFFLOADED_BYTES
            metrics, state, grads, _ = _train(cfg, plan, mesh)
            offloaded = TC.OFFLOADED_BYTES - before
            full = bridge.gather_train_state(state, cfg, plan, mesh)
            report = lower_plan(cfg, ShapeConfig("t", SEQ, GBS, "train"),
                                plan, plan_mesh(plan)).memory_report()
            local = _state_bytes(state, grads)
            spread = torch.tensor([local, -local], dtype=torch.float64)
            dist.all_reduce(spread, op=dist.ReduceOp.MAX)
            if rank == 0:
                results[name] = dict(
                    metrics=metrics, state=full, init_ok=bool(init_ok),
                    offloaded=offloaded,
                    local_bytes=(float(spread[0]), -float(spread[1])),
                    report_bytes=report.stages[0].state_bytes)
        if world == 2:
            results["sliced_z1"] = _sliced_update_is_bitwise()
    finally:
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()


def _sliced_update_is_bitwise() -> bool:
    """On every rank of a dp 2 ZeRO 1 world: the state after the steps
    with the update in slices of at most 64 elements equals, leaf for leaf
    and bit for bit, the state with each leaf updated whole (the grad norm
    clips nothing, so that the sliced sums of squares cannot move it)."""
    cfg, plan = _cfg(V), _plan(2, 1, CASES["dp2_z1"][2])
    mesh = make_plan_mesh(2, 1, "cpu")
    adam = TOPT.AdamConfig(grad_clip=1e30)
    finest = TOPT.SLICE_ELEMS
    try:
        TOPT.SLICE_ELEMS = 1 << 62
        _, whole, _, _ = _train(cfg, plan, mesh, adam=adam)
        TOPT.SLICE_ELEMS = 64
        _, sliced, _, _ = _train(cfg, plan, mesh, adam=adam)
    finally:
        TOPT.SLICE_ELEMS = finest
    ok = torch.tensor(float(all(
        torch.equal(a, b) for a, b in zip(_leaves(whole), _leaves(sliced)))))
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok)


def _start_world(world: int, out: pathlib.Path):
    port = train_launch._free_port()
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT / 'tests')!r}]; import test_torch_distributed as T; "
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank 0's results of every case, both world sizes started at once."""
    tmp = tmp_path_factory.mktemp("dist")
    worlds = {w: _start_world(w, tmp / f"ws{w}.pkl") for w in (2, 4)}
    results = {}
    for w, procs in worlds.items():
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=300)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
        assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
        with open(tmp / f"ws{w}.pkl", "rb") as f:
            results.update(pickle.load(f))
    return results


def _one_process(dp, tp, knobs, vocab):
    """The one-process run of a case's plan at dp = tp = 1: the same global
    micro-batches.  Returns its metrics, final state and grads' max |g|
    per step."""
    plan = _plan(dp, tp, knobs)
    st = plan.stages[0]
    plan = plan.replace(stages=(st.replace(
        dp=1, tp=1, micro_batch=st.micro_batch * st.dp),))
    metrics, state, _, amax = _train(_cfg(vocab), plan)
    return metrics, bridge.train_state_to_numpy(state), amax


def _close_update(got, want, what):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert err.max() <= LR / 2 and err.mean() <= 1e-6, \
        (what, float(err.max()), float(err.mean()))


def _int8_room(e, amax):
    """What one int8 level flipped by rounding at every step can move mu or
    nu by, elementwise: a gradient whose sum differs in its last bits may
    round to the next level, amax / 127 away (``fake_compress``)."""
    room = 0.0
    for a in amax:
        s = a / 127
        d = s if e == "mu" else (2 * a + s) * s
        b = ADAM.b1 if e == "mu" else ADAM.b2
        room = b * room + (1 - b) * d
    return room


def _close_moment(got, want, what, amax=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if amax is None:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= MOMENT_RTOL, (what, float(rel))
        return
    room = MOMENT_RTOL * np.abs(want) + _int8_room(what.split("/")[0], amax)
    excess = np.abs(got - want) - room
    assert excess.max() <= 0, (what, float(excess.max()))


def _hold(metrics, state, want_metrics, want_state, amax=None):
    """``amax``: each grad's max |g| per step, when the gradients were
    quantized to int8, so that mu and nu are held elementwise with room
    for one level (``_int8_room``)."""
    for t, w in zip(metrics, want_metrics):
        assert t["step"] == w["step"]
        np.testing.assert_allclose(t["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], w["grad_norm"], rtol=1e-4)
    for e in ("params", "master", "mu", "nu"):
        assert set(state[e]) == set(want_state[e])
        for n, v in want_state[e].items():
            close = (_close_update if e in ("params", "master") else
                     functools.partial(_close_moment,
                                       amax=amax[n] if amax else None))
            got = state[e][n]
            if isinstance(v, dict):
                for part in ("host", "dev"):
                    close(got[part], v[part], f"{e}/{n}/{part}")
            else:
                close(got, v, f"{e}/{n}")


@pytest.mark.parametrize("case", list(CASES))
def test_multi_device_step_matches_one_process(runs, case):
    """Every rank's ``init_sharded_state`` is its cut of the one-process
    state (``shard_train_state``); loss, grad norm, params, master, mu and
    nu after two steps, gathered whole, against the one-process step; each
    rank's state is exactly the bytes the memory report charges per
    device."""
    got = runs[case]
    assert got["init_ok"], case
    dp, tp, knobs, vocab = CASES[case]
    want_m, want_s, amax = _one_process(dp, tp, knobs, vocab)
    _hold(got["metrics"], got["state"], want_m, want_s,
          amax if knobs.get("grad_compression") else None)
    assert got["local_bytes"] == (got["report_bytes"],) * 2, case
    # the AO hook took the offload layers' inputs (this rank's rows, and
    # part of the sequence under SP), never a weight, ZeRO-3 gathers too
    plan = _plan(dp, tp, knobs)
    st = plan.stages[0]
    off = int(round(st.ao * min(st.ckpt_layers, st.layers)))
    seq = SEQ // tp if plan.sequence_parallel else SEQ
    assert got["offloaded"] == STEPS * plan.grad_accum * off * \
        st.micro_batch * seq * TCFG.d_model * 4, case


def test_sliced_adam_update_is_bitwise_on_a_zero1_shard(runs):
    """Each rank of dp 2 ZeRO 1 updates its data part of master/mu/nu
    (``StateSharding.opt_grad``) in slices exactly as it would update the
    whole part."""
    assert runs["sliced_z1"]


def test_world_size_one_is_bitwise_the_one_device_step():
    """Every collective on groups of one: losses, grad norms and every
    leaf of the state equal the one-device step's bit for bit (ZeRO 1,
    remat on 2 layers with one offloading, WO = OO = 0.5)."""
    knobs = dict(zero=1, ckpt_layers=2, ao=0.5, wo=0.5, oo=0.5)
    plan = _plan(1, 1, knobs)
    want_m, want_s = _train(TCFG, plan)[:2]
    want = bridge.train_state_to_numpy(want_s)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{train_launch._free_port()}",
        rank=0, world_size=1)
    try:
        mesh = make_plan_mesh(1, 1, "cpu")
        got_m, state = _train(TCFG, plan, mesh)[:2]
        got = bridge.gather_train_state(state, TCFG, plan, mesh)
    finally:
        dist.destroy_process_group()
    assert got_m == want_m
    for e in ("params", "master", "mu", "nu"):
        for n, v in want[e].items():
            pairs = [(got[e][n][k], v[k]) for k in v] \
                if isinstance(v, dict) else [(got[e][n], v)]
            for a, b in pairs:
                np.testing.assert_array_equal(a, b, err_msg=f"{e}/{n}")


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
cfg = get_arch('granite-3-8b').reduced().replace(vocab_size=inp["vocab"])
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


def _hold_to_the_reference_mesh(runs, case, tmp_path):
    """The reference's make_train_step on a dp x tp mesh of forced host
    devices, from the port's initial weights and batches: loss, grad norm,
    params, master, mu and nu after two steps, against the port's ranks."""
    dp, tp, knobs, vocab = CASES[case]
    cfg, plan = _cfg(vocab), _plan(dp, tp, knobs)
    model = build_model(cfg, "cpu")
    params, _ = model.init(torch.Generator().manual_seed(0), torch.float32)
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump({"plan": plan.to_json(), "vocab": vocab,
                     "params": bridge.params_to_numpy(params),
                     "batches": [{k: v.numpy() for k, v in b.items()}
                                 for b in _batches(cfg)]}, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={dp * tp}"}
    r = subprocess.run([sys.executable, "-c", REFERENCE_MESH,
                        str(tmp_path / "in.pkl"), str(tmp_path / "out.pkl")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    got = runs[case]
    _hold(got["metrics"], got["state"], ref["metrics"], ref["state"])


def test_dp2_tp2_zero2_matches_the_reference_mesh(runs, tmp_path):
    """dp 2 x tp 2 at ZeRO 2 against the reference on a 2 x 2 mesh."""
    _hold_to_the_reference_mesh(runs, "dp2_tp2_z2", tmp_path)


def test_replicated_vocab_tp4_sp_matches_the_reference_mesh(runs, tmp_path):
    """tp 4 with sequence parallelism at vocab 511 (the embedding and the
    head replicated, as granite-3-8b's at tp 4) against the reference on a
    1 x 4 mesh."""
    _hold_to_the_reference_mesh(runs, "tp4_sp_v511", tmp_path)


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("zero", [0, 1, 2, 3])
def test_spec_tables_follow_the_choosers_and_the_memory_report(tp, zero):
    """granite-3-8b at full width, dp 2: every tensor's param / grad / opt
    spec splits the dims choose_tp_dim and choose_fsdp_dim pick, at the
    ZeRO thresholds; a rank's shards (WO = OO = 0.5) sum to the memory
    report's state bytes exactly."""
    cfg = get_arch(ARCH)
    dp = 2
    plan = single_stage_plan(cfg.num_layers, dp=dp, tp=tp, micro_batch=1,
                             grad_accum=1, zero=zero, wo=0.5, oo=0.5)
    low = lower_plan(cfg, ShapeConfig("t", 4096, 2, "train"), plan,
                     plan_mesh(plan))
    tables = {"param": (low.param_specs(), 3), "grad": (low.grad_specs(), 2),
              "opt": (low.opt_specs(), 1)}
    params, axes = build_model(cfg, "meta").init(None)
    local = 0.0
    for n, p in params.items():
        shape = tuple(p.shape)
        ti = choose_tp_dim(axes[n], shape, tp, False)
        fi = choose_fsdp_dim(axes[n], shape, dp, ti)
        numel = {}
        for kind, (specs, at) in tables.items():
            want = [None] * len(shape)
            if ti is not None:
                want[ti] = "model"
            if zero >= at and fi is not None:
                want[fi] = "data"
            assert specs[n] == tuple(want), (kind, n)
            numel[kind] = int(np.prod(shape)) // (
                (tp if ti is not None else 1)
                * (dp if zero >= at and fi is not None else 1))
        k_m = TOPT.split_k(n, shape, axes, 0.5)
        dev = (shape[0] - k_m) / shape[0] if k_m else 1.0
        local += (2 * numel["param"] + 4 * numel["grad"]
                  + 12 * numel["opt"] * dev)
    assert local == low.memory_report().stages[0].state_bytes
    states = low.state_specs()
    assert states["params"] == low.param_specs()
    wq = states["master"]["layers/attn/wq"]
    assert wq == {"host": low.opt_specs()["layers/attn/wq"],
                  "dev": low.opt_specs()["layers/attn/wq"]}


def test_launcher_trains_a_tp2_dp2_zero3_plan_on_four_ranks(tmp_path):
    """``train --nproc 4 --plan-json`` (tp 2 x dp 2, ZeRO 3, remat on half
    the layers) trains and its loss falls; a plan for 4 ranks on 2 exits
    non-zero."""
    plan = single_stage_plan(TCFG.num_layers, dp=2, tp=2, micro_batch=2,
                             grad_accum=2, zero=3, ckpt_layers=2,
                             attn_impl="pallas", use_pallas=True)
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    save = tmp_path / "final.npz"
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
            "--plan-json", str(path)]
    assert train_launch.main(argv + ["--nproc", "4", "--save-params",
                                     str(save)]) == 0
    with np.load(save) as f:
        losses = f["losses"]
        assert f["embed/w"].shape == (TCFG.vocab_size, TCFG.d_model)
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert train_launch.main(argv + ["--nproc", "2"]) == 1
