"""Pipelined training (S > 1) of the PyTorch port on the CPU, over gloo, at
reduced granite-3-8b (4 layers, d 128, 4 heads, 1 KV head, d_ff 256, vocab
512, tied embeddings) in f32, global batch 8 of 64 tokens in G = 2
micro-batches, Adam at its defaults (the clip at 1.0 is live: every
step's grad norm is above 1), two steps.

Every rank starts from its cut of the one-process state of seed 0
(``bridge.shard_train_state``); the ranks of each world size (2 and 4)
are processes started together, as ``torchrun`` starts them, and run every
case of their size; rank 0 gathers each final state whole
(``bridge.gather_train_state``).  Each case is held:

- loss of the first step within 5e-3 of the reference's one-device
  ``model.loss_fn`` averaged over the micro-batches (what the reference's
  own pipeline test compares, ``tests/test_pipeline_multidev.py``), and
  every step's loss within 1e-5 relative of the port's one-process step;
- after two steps, params and master within lr/2 elementwise and 1e-6 on
  average, mu and nu within 1e-4 of their norm, of the reference's
  single-stage ``make_train_step`` on one device (the multi-device row of
  ``docs/port.md``); grad norms within 1e-4 relative;
- each rank's state is exactly the bytes ``stage_layout_terms`` charges its
  stage, and ``init_sharded_state`` is its cut of the one-process init.
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

from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.plan import Plan, StageConfig, single_stage_plan
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import init_distributed, make_plan_mesh
from repro_torch.lowering import check_train_plan, lower_plan, plan_mesh
from repro_torch.lowering.memory import stage_layout_terms
from repro_torch.models.zoo import build_model
from repro_torch.parallel.pipeline import make_pipeline_train_step
from repro_torch.training import optimizer as TOPT
from repro_torch.training import step as TSTEP
from repro_torch.training.data import BatchSpec, SyntheticLM

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "granite-3-8b"
TCFG = get_arch(ARCH).reduced()
GBS, SEQ, G, STEPS = 8, 64, 2, 2
LR = TOPT.AdamConfig().lr
MOMENT_RTOL = 1e-4
# the reference's own pipeline test holds its loss to this
REF_LOSS_ATOL = 5e-3

# name -> (S, dp, tp, per-stage knobs, plan knobs)
CASES = {
    "s2_ckpt2_on_stage0": (2, 1, 1, [dict(layers=2, ckpt_layers=2),
                                     dict(layers=2)], {}),
    "s2_layers_3_1": (2, 1, 1, [dict(layers=3), dict(layers=1)], {}),
    "s2_dp2_z1_wo_oo_stage0": (2, 2, 1, [dict(layers=2, wo=0.5, oo=0.5),
                                         dict(layers=2)], {}),
    "s2_tp2_sp": (2, 1, 2, [dict(layers=2), dict(layers=2)],
                  dict(sequence_parallel=True)),
    "s4": (4, 1, 1, [dict(layers=1)] * 4, {}),
}


def _plan(S, dp, tp, stages, knobs) -> Plan:
    return Plan(grad_accum=G, attn_impl="blocked", stages=tuple(
        StageConfig(**{"micro_batch": GBS // (G * dp), "dp": dp, "tp": tp,
                       "zero": 1, "ckpt_layers": 0, **st})
        for st in stages), **knobs)


def _batches():
    data = SyntheticLM(BatchSpec(global_batch=GBS, seq_len=SEQ,
                                 vocab_size=TCFG.vocab_size))
    return [{k: torch.from_numpy(v) for k, v in data.batch(i).items()}
            for i in range(STEPS)]


def _one_process_state():
    """The one-process f32 params and train state of seed 0."""
    model = build_model(TCFG, "cpu")
    params, axes = model.init(torch.Generator().manual_seed(0),
                              torch.float32)
    plan = single_stage_plan(TCFG.num_layers, dp=1, tp=1,
                             micro_batch=GBS // G, grad_accum=G)
    return model, params, TOPT.init_state(params, axes, plan.stages[0]), plan


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
        for n, v in sorted(state[e].items()):
            yield from (v.values() if isinstance(v, dict) else (v,))


def _run_case(name, world) -> dict:
    """One case on this rank: two steps from its cut of the one-process
    state; returns rank 0's results (None elsewhere)."""
    S, dp, tp, stages, knobs = CASES[name]
    plan = _plan(S, dp, tp, stages, knobs)
    mesh = make_plan_mesh(dp, tp, "cpu", S)
    model, _, one, one_plan = _one_process_state()
    # init_sharded_state draws the whole model and keeps this rank's part
    cut = bridge.shard_train_state(
        bridge.train_state_to_numpy(TSTEP.init_train_state(
            model, one_plan, torch.Generator().manual_seed(0))),
        TCFG, plan, mesh)
    mine = TSTEP.init_sharded_state(model, plan, mesh,
                                    torch.Generator().manual_seed(0))
    init_ok = all(a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in zip(_leaves(cut), _leaves(mine))) and \
        all(set(cut[e]) == set(mine[e]) for e in ("params", "master"))
    state = bridge.shard_train_state(bridge.train_state_to_numpy(one), TCFG,
                                     plan, mesh, param_dtype=torch.float32)
    seen = {}
    real = TOPT.adam_update

    def spy(state, grads, *a):
        seen.update({n: tuple(g.shape) for n, g in grads.items()})
        return real(state, grads, *a)

    TOPT.adam_update = spy
    try:
        step = make_pipeline_train_step(model, plan, mesh)
        metrics = []
        for b in _batches():
            state, m = step.fn(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        TOPT.adam_update = real
    low = lower_plan(TCFG, ShapeConfig("t", SEQ, GBS, "train"), plan,
                     plan_mesh(plan))
    terms = stage_layout_terms(low, step.stage)
    charged = sum(terms[k] for k in ("weight", "grad", "master", "opt"))
    ok = torch.tensor([float(init_ok),
                       float(_state_bytes(state, seen) == charged)])
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    full = bridge.gather_train_state(state, TCFG, plan, mesh)
    if dist.get_rank() != 0:
        return None
    return dict(metrics=metrics, state=full, init_ok=bool(ok[0]),
                bytes_ok=bool(ok[1]))


def _rank_main(out: str) -> None:
    rank, world, _ = init_distributed("cpu")
    results = {}
    try:
        for name, (S, dp, tp, _, _) in CASES.items():
            if S * dp * tp == world:
                results[name] = _run_case(name, world)
    finally:
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()


def _start_world(world: int, out: pathlib.Path):
    port = train_launch._free_port()
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT / 'tests')!r}]; import test_torch_pipeline as T; "
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


def _reference(params_np, batches):
    """The reference on one device from the same weights and batches: its
    ``model.loss_fn`` of each micro-batch of the first batch, and its
    single-stage ``make_train_step`` over every batch (metrics and final
    state)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.configs.base import get_arch as jax_get_arch
    from repro.core.plan import single_stage_plan as jax_plan
    from repro.launch.mesh import make_host_mesh
    from repro.lowering import lower_plan as jax_lower_plan
    from repro.models.common import ExecConfig as JExecConfig
    from repro.models.zoo import build_model as jax_build_model
    from repro.training import optimizer as JOPT
    from repro.training.step import make_train_step as jax_make_train_step

    cfg = jax_get_arch(ARCH).reduced()
    model = jax_build_model(cfg)
    params = {n: jnp.asarray(v) for n, v in params_np.items()}
    ec = JExecConfig(ckpt_layers=0, remat_policy="none",
                     compute_dtype=jnp.float32, attn_impl="blocked")
    mb = GBS // G
    first = batches[0]
    micro_losses = [float(model.loss_fn(
        params, {k: jnp.asarray(v[i * mb:(i + 1) * mb].numpy())
                 for k, v in first.items()}, ec)) for i in range(G)]
    jplan = jax_plan(cfg.num_layers, dp=1, tp=1, micro_batch=mb,
                     grad_accum=G, zero=1, attn_impl="blocked")
    mesh = make_host_mesh(1, 1)
    with compat.set_mesh(mesh):
        low = jax_lower_plan(cfg, None, jplan, mesh)
        st = low.stages[0]
        low = dataclasses.replace(low, stages=(dataclasses.replace(
            st, exec_cfg=st.exec_cfg.replace(compute_dtype=jnp.float32)),))
        step = jax_make_train_step(model, jplan, mesh, donate=False,
                                   lowered=low)
        state = jax.device_put(
            JOPT.init_state(params, low.axes_table, jplan.stages[0]),
            low.state_shardings())
        metrics = []
        for b in batches:
            state, m = step.fn(state, {k: jnp.asarray(v.numpy())
                                       for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        state = jax.tree.map(np.asarray, state)
    return float(np.mean(micro_losses)), metrics, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank 0's results of every case (both worlds started at once), the
    port's one-process run and the reference's."""
    tmp = tmp_path_factory.mktemp("pipe")
    worlds = {w: _start_world(w, tmp / f"ws{w}.pkl") for w in (2, 4)}
    model, params, state, plan = _one_process_state()
    ref = _reference(bridge.params_to_numpy(params), _batches())
    step = TSTEP.make_train_step(model, plan.replace(attn_impl="blocked"))
    one = []
    for b in _batches():    # updates params in place
        state, m = step.fn(state, b)
        one.append({k: float(v) for k, v in m.items()})
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
    return results, one, ref


def _close_update(got, want, what):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert err.max() <= LR / 2 and err.mean() <= 1e-6, \
        (what, float(err.max()), float(err.mean()))


def _close_moment(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= MOMENT_RTOL, (what, float(rel))


def _whole(v):
    return np.concatenate([v["host"], v["dev"]]) if isinstance(v, dict) \
        else v


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_step_matches_the_reference(runs, case):
    """Loss against the reference's one-device loss_fn and the port's
    one-process step; grad norm above the clip; params, master, mu and nu
    after two steps against the reference's one-device make_train_step;
    the init and each rank's state bytes (module docstring)."""
    results, one, (ref_loss, ref_metrics, ref_state) = runs
    got = results[case]
    assert got["init_ok"] and got["bytes_ok"], case
    assert abs(got["metrics"][0]["loss"] - ref_loss) <= REF_LOSS_ATOL
    for t, o, r in zip(got["metrics"], one, ref_metrics):
        assert t["step"] == o["step"] == r["step"]
        np.testing.assert_allclose(t["loss"], o["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], r["grad_norm"],
                                   rtol=1e-4)
        assert t["grad_norm"] > TOPT.AdamConfig().grad_clip
    for e in ("params", "master", "mu", "nu"):
        assert set(got["state"][e]) == set(ref_state[e])
        close = _close_update if e in ("params", "master") else \
            _close_moment
        for n, v in ref_state[e].items():
            close(_whole(got["state"][e][n]), _whole(v), f"{e}/{n}")


def test_plans_the_pipeline_cannot_run_are_refused():
    """Stages that differ in (dp, tp), a world of another size than S · dp
    · tp, and stages whose layers do not add up to the model's; each
    refusal names ROADMAP.md."""
    ok = _plan(2, 1, 2, [dict(layers=2), dict(layers=2)], {})
    check_train_plan(ok, 4, TCFG.num_layers)
    uneven = ok.replace(stages=(ok.stages[0], ok.stages[1].replace(
        dp=2, tp=1, micro_batch=2)))
    bad = [(uneven, 4, None), (ok, 2, None), (ok, 8, None),
           (ok.replace(stages=(ok.stages[0].replace(layers=3),
                               ok.stages[1])), 4, TCFG.num_layers)]
    for plan, world, layers in bad:
        with pytest.raises(ValueError, match="ROADMAP"):
            check_train_plan(plan, world, layers)


def test_launcher_trains_a_two_stage_plan_on_two_ranks(tmp_path, capsys):
    """``train --nproc 2 --plan-json`` with a two-stage plan (1F1B over
    gloo) trains and its loss falls; a pipelined plan whose stages differ
    in (dp, tp) exits non-zero with its reason."""
    plan = _plan(2, 1, 1, [dict(layers=3, ckpt_layers=1), dict(layers=1)],
                 {}).replace(attn_impl="pallas", use_pallas=True)
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    save = tmp_path / "final.npz"
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
            "--plan-json", str(path)]
    assert train_launch.main(argv + ["--nproc", "2", "--save-params",
                                     str(save)]) == 0
    with np.load(save) as f:
        losses = f["losses"]
        assert f["layers/attn/wq"].shape[0] == TCFG.num_layers
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    uneven = plan.replace(stages=(plan.stages[0], plan.stages[1].replace(
        tp=2)))
    path.write_text(uneven.to_json())
    capsys.readouterr()
    assert train_launch.main(argv) == 1
    assert "ROADMAP" in capsys.readouterr().out
