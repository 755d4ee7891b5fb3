"""The port's fault-tolerant training loop, checkpointer and ``PackedCorpus``
on the CPU, at reduced granite-3-8b (4 layers, d 128, 4 heads, 1 KV head,
d_ff 256, vocab 512).

- The reference's own cases (``tests/test_checkpoint_data_loop.py``), each
  run against the port's counterparts.
- ``PackedCorpus`` batches bit for bit equal to the reference's.
- Checkpoints across the packages: one the port writes (bf16 params, WO =
  OO = 0.5) reads back in the reference's ``Checkpointer`` bit for bit,
  bf16 bits included; one the reference writes restores in the port, whose
  next step is held to the reference's next step.
- The snapshot is the state at save time even when a step rewrites the
  state in place before the background write runs.
- On the real model (bf16, one device, CKPT, AO and WO/OO): a restart after
  a fault, a rollback after a non-finite loss and a resume onto a fresh
  state are each bit for bit the uninterrupted run.
- Over gloo, in worlds of 2 and 4 ranks started as ``torchrun`` starts
  them: the masked loss under dp 2, tp 2 with SP and S 2 against the
  reference's one-device ``make_train_step`` (the global micro-batch's
  masked mean); every rank taking the same non-finite and restart
  decisions, bit for bit the uninterrupted run; and elastic restores of a
  dp 2 x tp 2 ZeRO 1 checkpoint onto dp 4 ZeRO 2, S 2 x dp 2 and one
  process with WO = OO = 0.5, each step held to the one-process step from
  the same checkpoint.
- The launcher: ``train --ckpt-every 2`` writes steps 2 and 4, on one
  process and with ``--nproc 2`` (rank 0 writes the gathered state).

Tolerances (f32): the multi-device row of ``docs/port.md`` -- loss 1e-5 and
grad norm 1e-4 relative; params and master within lr/2 elementwise and
1e-6 on average; mu and nu within 1e-4 of their norm.
"""
import json
import os
import pathlib
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.core.plan import Plan, StageConfig, single_stage_plan
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import init_distributed, make_plan_mesh
from repro_torch.models.zoo import build_model
from repro_torch.training import optimizer as TOPT
from repro_torch.training import step as TSTEP
from repro_torch.training.checkpoint import (Checkpointer, StatePlacement,
                                             _flatten, _unflatten)
from repro_torch.training.data import (BatchSpec, PackedCorpus, SyntheticLM,
                                       microbatched)
from repro_torch.training.loop import LoopConfig, TrainLoop

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "granite-3-8b"
TCFG = get_arch(ARCH).reduced()
V = TCFG.vocab_size
GBS, SEQ, G = 8, 64, 2
LR = TOPT.AdamConfig().lr
MOMENT_RTOL = 1e-4


# -- the reference's cases: checkpoint --------------------------------------


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "step": np.int32(7),
        "params": {"a/w": rng.normal(size=(4, 8)).astype(np.float32),
                   "b/w": rng.normal(size=(3,)).astype(np.float32)},
        "mu": {"a/w": {"host": rng.normal(size=(2, 8)).astype(np.float32),
                       "dev": rng.normal(size=(2, 8)).astype(np.float32)}},
    }


def test_flatten_roundtrip():
    s = _state()
    assert _unflatten(_flatten(s)).keys() == s.keys()
    f = _flatten(s)
    assert "mu::a/w::host" in f


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    s = _state()
    ck.save(7, s, {"arch": "test"})
    step, restored, manifest = ck.restore()
    assert step == 7
    assert manifest["arch"] == "test"
    np.testing.assert_array_equal(restored["params"]["a/w"],
                                  s["params"]["a/w"])
    np.testing.assert_array_equal(restored["mu"]["a/w"]["host"],
                                  s["mu"]["a/w"]["host"])


def test_atomic_no_tmp_left(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _state())
    assert not list(tmp_path.glob(".tmp_*"))
    assert (tmp_path / "step_000000001" / "MANIFEST.json").exists()


def test_gc_keeps_newest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for i in (1, 2, 3, 4):
        ck.save(i, _state())
    assert ck.all_steps() == [3, 4]


def test_async_save(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save_async(5, _state())
    ck.wait()
    assert ck.latest_step() == 5


def test_restore_specific_step(tmp_path):
    ck = Checkpointer(tmp_path, keep=5)
    for i in (1, 2, 3):
        st = _state(i)
        ck.save(i, st)
    step, restored, _ = ck.restore(2)
    assert step == 2
    np.testing.assert_array_equal(restored["params"]["a/w"],
                                  _state(2)["params"]["a/w"])


def test_elastic_reshard_to_device(tmp_path):
    """Restore with a target placement puts each leaf of this rank's part
    on the device, split by the target plan's WO/OO (here none, from a
    checkpoint split at WO = OO = 0.5)."""
    split, whole = (single_stage_plan(TCFG.num_layers, dp=1, tp=1,
                                      micro_batch=1, grad_accum=1, wo=r,
                                      oo=r) for r in (0.5, 0.0))
    state = TSTEP.init_train_state(build_model(TCFG, "cpu"), split,
                                   torch.Generator().manual_seed(0))
    ck = Checkpointer(tmp_path)
    ck.save(1, state)
    _, restored, _ = ck.restore(place=StatePlacement(TCFG, whole, None,
                                                     "cpu"))
    w = "layers/attn/wq"
    assert TOPT.is_split(state["master"][w])
    got = restored["master"][w]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert torch.equal(got, bridge._joined(state["master"][w]))
    assert restored["params"][w].dtype == torch.bfloat16
    assert torch.equal(restored["params"][w], state["params"][w])


def test_wait_reraises_the_writers_error(tmp_path):
    class Failing(Checkpointer):
        def _write(self, *a):
            raise OSError("disk full")

    ck = Failing(tmp_path)
    ck.save_async(1, _state())
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()       # raised once


# -- the reference's cases: data ----------------------------------------------


def test_synthetic_deterministic():
    spec = BatchSpec(global_batch=8, seq_len=32, vocab_size=100)
    d = SyntheticLM(spec, seed=1)
    b1, b2 = d.batch(5), d.batch(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = d.batch(6)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_synthetic_shards_differ():
    a = SyntheticLM(BatchSpec(8, 32, 100, n_shards=2, shard=0), seed=1)
    b = SyntheticLM(BatchSpec(8, 32, 100, n_shards=2, shard=1), seed=1)
    assert not np.array_equal(a.batch(0)["tokens"], b.batch(0)["tokens"])
    assert a.batch(0)["tokens"].shape == (4, 32)


def test_labels_are_shifted_tokens():
    d = SyntheticLM(BatchSpec(2, 16, 50), seed=0)
    b = d.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_packed_corpus_mask_and_bounds():
    docs = [np.arange(1, 6), np.arange(10, 30)]
    spec = BatchSpec(global_batch=4, seq_len=16, vocab_size=64)
    pc = PackedCorpus(docs, spec, seed=0)
    b = pc.batch(0)
    assert b["tokens"].shape == (4, 16)
    assert b["loss_mask"].shape == (4, 16)
    assert set(np.unique(b["loss_mask"])) <= {0.0, 1.0}
    np.testing.assert_array_equal(pc.batch(0)["tokens"], b["tokens"])


def test_microbatched_layout():
    b = {"tokens": np.arange(24).reshape(8, 3)}
    mb = microbatched(b, 4)
    assert mb["tokens"].shape == (4, 2, 3)
    np.testing.assert_array_equal(mb["tokens"].reshape(8, 3), b["tokens"])


def _docs(seed=0, n=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, size=int(rng.integers(3, 40)))
            for _ in range(n)]


@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (0, 5, 1),
                                             (3, 2, 0), (7, 11, 3)])
def test_packed_corpus_matches_the_reference_bit_for_bit(seed, step, shard):
    from repro.training.data import BatchSpec as JBatchSpec
    from repro.training.data import PackedCorpus as JPackedCorpus
    docs = _docs(seed)
    args = dict(global_batch=8, seq_len=48, vocab_size=V, n_shards=4,
                shard=shard)
    got = PackedCorpus(docs, BatchSpec(**args), seed=seed, eos=2,
                       pad=1).batch(step)
    want = JPackedCorpus(docs, JBatchSpec(**args), seed=seed, eos=2,
                         pad=1).batch(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# -- the reference's cases: loop ----------------------------------------------


def _toy_step(lr=0.5):
    def step(state, batch):
        w = state["w"]
        loss = float(np.sum((w - 3.0) ** 2))
        return {"w": w - lr * 2 * (w - 3.0)}, {"loss": loss}
    return step


def _toy_batches(step):
    return {"x": np.zeros((1,))}


def test_loop_runs_and_converges(tmp_path):
    loop = TrainLoop(_toy_step(), {"w": np.zeros((2,), np.float32)},
                     _toy_batches, ckpt_dir=tmp_path,
                     cfg=LoopConfig(total_steps=20, ckpt_every=5))
    stats = loop.run()
    assert stats.steps_done == 20
    assert stats.losses[-1] < stats.losses[0]
    assert Checkpointer(tmp_path).latest_step() == 20


def test_loop_fault_injection_restores(tmp_path):
    calls = {"n": 0}

    def fault(step):
        if step == 12 and calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("simulated node failure")

    loop = TrainLoop(_toy_step(), {"w": np.zeros((2,), np.float32)},
                     _toy_batches, ckpt_dir=tmp_path,
                     cfg=LoopConfig(total_steps=20, ckpt_every=5),
                     fault_hook=fault)
    stats = loop.run()
    assert stats.restarts == 1
    assert stats.steps_done >= 20   # steps 10..12 replayed after restore


def test_loop_exceeds_max_restarts(tmp_path):
    def always_fail(step):
        raise RuntimeError("dead node")

    loop = TrainLoop(_toy_step(), {"w": np.zeros((2,))}, _toy_batches,
                     ckpt_dir=tmp_path,
                     cfg=LoopConfig(total_steps=5, max_restarts=2),
                     fault_hook=always_fail)
    with pytest.raises(RuntimeError):
        loop.run()


def test_loop_nan_rollback(tmp_path):
    hits = {"n": 0}

    def step(state, batch):
        w = state["w"]
        hits["n"] += 1
        if hits["n"] == 7:
            return {"w": w}, {"loss": float("nan")}
        return {"w": w + 1}, {"loss": 1.0}

    loop = TrainLoop(step, {"w": np.zeros((1,), np.float32)}, _toy_batches,
                     ckpt_dir=tmp_path,
                     cfg=LoopConfig(total_steps=10, ckpt_every=2))
    stats = loop.run()
    assert stats.rollbacks == 1
    # replayed steps after the rollback also count as executed work
    assert stats.steps_done >= 10


def test_loop_stops_on_a_loss_that_is_non_finite_again(tmp_path):
    """A step that is non-finite again after its rollback raises (the
    reference rolls back without end), and the restarts run out."""
    def step(state, batch):
        return state, {"loss": float("nan") if batch["i"] == 3 else 1.0}

    loop = TrainLoop(step, {"w": np.zeros((1,))}, lambda i: {"i": i},
                     ckpt_dir=tmp_path,
                     cfg=LoopConfig(total_steps=6, ckpt_every=2,
                                    max_restarts=2))
    with pytest.raises(RuntimeError, match="max_restarts"):
        loop.run()
    assert loop.stats.rollbacks == 1 and loop.stats.restarts == 3


def test_loop_straggler_detection(tmp_path):
    times = iter([0.01] * 8 + [0.2] + [0.01] * 11)

    def step(state, batch):
        time.sleep(next(times))
        return state, {"loss": 1.0}

    loop = TrainLoop(step, {"w": np.zeros((1,))}, _toy_batches,
                     ckpt_dir=tmp_path,
                     cfg=LoopConfig(total_steps=20, straggler_factor=3.0))
    stats = loop.run()
    assert stats.straggler_events >= 1


# -- the real model, one device (bf16) ------------------------------------------

# CKPT 2 of 4 with one offloading layer, WO = OO = 0.5: split leaves
LOOP_PLAN = single_stage_plan(TCFG.num_layers, dp=1, tp=1, micro_batch=2,
                              grad_accum=2, zero=1, ckpt_layers=2, ao=0.5,
                              wo=0.5, oo=0.5, attn_impl="pallas",
                              use_pallas=True)
LOOP_STEPS, LOOP_EVERY = 7, 3


def _bits(x):
    """A leaf's bits as numpy: bf16 (a tensor, or the reference's numpy
    bf16) as uint16."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_bitwise(got, want, what=""):
    """Two state trees (tensors or arrays), leaf by leaf, bit for bit."""
    fg, fw = _flatten(got), _flatten(want)
    assert fg.keys() == fw.keys(), what
    for k in fw:
        a, b = _bits(fg[k]), _bits(fw[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        assert np.array_equal(a, b), (what, k)


def _fresh(seed=0, plan=LOOP_PLAN):
    return TSTEP.init_train_state(build_model(TCFG, "cpu"), plan,
                                  torch.Generator().manual_seed(seed))


def _run_loop(ckdir, fault=None, poison_at=None, state=None, start=0,
              steps=LOOP_STEPS):
    """The real model's loop: returns (stats, [(step, loss)] of every
    executed step, replays included, and the final state's host copy)."""
    step = TSTEP.make_train_step(build_model(TCFG, "cpu"), LOOP_PLAN)
    data = SyntheticLM(BatchSpec(4, SEQ, V))
    cur, seen, poisoned = {}, [], []

    def batches(i):
        cur["i"] = i
        return {k: torch.from_numpy(v) for k, v in data.batch(i).items()}

    def fn(state, batch):
        if cur["i"] == poison_at and not poisoned:
            poisoned.append(cur["i"])
            state["params"]["embed/w"].fill_(float("nan"))
        state, m = step.fn(state, batch)
        seen.append((cur["i"], float(m["loss"])))
        return state, m

    loop = TrainLoop(fn, _fresh() if state is None else state, batches,
                     ckpt_dir=ckdir, fault_hook=fault,
                     cfg=LoopConfig(total_steps=steps,
                                    ckpt_every=LOOP_EVERY))
    loop._step = start
    stats = loop.run()
    return stats, seen, bridge.train_state_to_numpy(loop.state)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop_a")
    return (d,) + _run_loop(d)


def test_uninterrupted_loop_checkpoints_every_third_step(uninterrupted):
    d, stats, seen, _ = uninterrupted
    assert stats.steps_done == LOOP_STEPS and stats.restarts == 0
    assert [i for i, _ in seen] == list(range(LOOP_STEPS))
    assert Checkpointer(d).all_steps() == [3, 6]
    assert all(np.isfinite(x) for _, x in seen)
    assert len(stats.snapshot_times) == 3       # steps 0, 3 and 6
    assert stats.snapshot_bytes == sum(
        x.numel() * x.element_size()
        for x in _flatten(_fresh()).values())


def test_fault_restart_is_bitwise_the_uninterrupted_run(uninterrupted,
                                                        tmp_path):
    _, _, want_seen, want = uninterrupted
    calls = []

    def fault(step):
        if step == 5 and not calls:
            calls.append(step)
            raise RuntimeError("simulated node failure")

    stats, seen, got = _run_loop(tmp_path, fault=fault)
    assert stats.restarts == 1
    # steps 3 and 4 replayed from the step-3 checkpoint
    assert [i for i, _ in seen] == [0, 1, 2, 3, 4, 3, 4, 5, 6]
    losses = dict(want_seen)
    assert all(x == losses[i] for i, x in seen)
    _assert_bitwise(got, want, "fault")


def test_nan_rollback_is_bitwise_the_uninterrupted_run(uninterrupted,
                                                       tmp_path):
    _, _, want_seen, want = uninterrupted
    stats, seen, got = _run_loop(tmp_path, poison_at=4)
    assert stats.rollbacks == 1 and stats.restarts == 0
    assert [i for i, _ in seen] == [0, 1, 2, 3, 4, 3, 4, 5, 6]
    assert np.isnan(seen[4][1])
    losses = dict(want_seen)
    assert all(x == losses[i] for i, x in seen[:4] + seen[5:])
    _assert_bitwise(got, want, "nan")


def test_resume_onto_a_fresh_state_is_bitwise(uninterrupted, tmp_path):
    d, _, want_seen, want = uninterrupted
    live = _fresh(seed=1)
    pinned = live["master"]["layers/attn/wq"]["host"]
    step, state, manifest = TrainLoop.resume(
        d, StatePlacement(TCFG, LOOP_PLAN, None, "cpu"), into=live)
    assert step == 6 and manifest["step"] == 6 and state is live
    # written in place: the live tensors stay
    assert state["master"]["layers/attn/wq"]["host"] is pinned
    stats, seen, got = _run_loop(tmp_path, state=state, start=6)
    assert seen == [want_seen[6]]
    _assert_bitwise(got, want, "resume")


def test_snapshot_is_not_torn_by_an_in_place_step(tmp_path):
    """save_async, then a step that rewrites the state in place before the
    background write runs: the checkpoint holds the state at save time.
    A snapshot of numpy views of the live CPU tensors fails here."""
    model = build_model(TCFG, "cpu")
    step = TSTEP.make_train_step(model, LOOP_PLAN)
    state = _fresh()
    data = SyntheticLM(BatchSpec(4, SEQ, V))

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in data.batch(i).items()}

    state, _ = step.fn(state, batch(0))
    want = bridge.train_state_to_numpy(state)
    gate = threading.Event()

    class Gated(Checkpointer):
        def _write(self, *a):
            assert gate.wait(60)
            return super()._write(*a)

    ck = Gated(tmp_path)
    ck.save_async(1, state)
    state, _ = step.fn(state, batch(1))         # in place
    gate.set()
    ck.wait()
    _, restored, _ = ck.restore(1)
    _assert_bitwise(bridge.train_state_to_numpy(restored), want)
    moved = bridge.train_state_to_numpy(state)
    assert not np.array_equal(moved["master"]["layers/attn/wq"]["host"],
                              want["master"]["layers/attn/wq"]["host"])


# -- across the packages --------------------------------------------------------


def test_a_port_checkpoint_reads_back_in_the_reference(tmp_path):
    """bf16 params, f32 master / mu / nu split at WO = OO = 0.5, after one
    step: the reference's ``Checkpointer.restore`` gives every leaf bit for
    bit, bf16 as ml_dtypes bfloat16 with the same bits."""
    from repro.training.checkpoint import Checkpointer as JCheckpointer
    model = build_model(TCFG, "cpu")
    state = _fresh()
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(BatchSpec(4, SEQ, V)).batch(0).items()}
    state, _ = TSTEP.make_train_step(model, LOOP_PLAN).fn(state, batch)
    Checkpointer(tmp_path).save(1, state, {"arch": TCFG.name})
    step, ref, manifest = JCheckpointer(tmp_path).restore()
    assert step == 1 and manifest["arch"] == TCFG.name
    assert ref["params"]["embed/w"].dtype.name == "bfloat16"
    assert TOPT.is_split(state["mu"]["layers/mlp/wu"])
    _assert_bitwise(ref, state)


def _ref_plan_json():
    return single_stage_plan(TCFG.num_layers, dp=1, tp=1,
                             micro_batch=GBS // G, grad_accum=G, zero=1,
                             wo=0.5, oo=0.5, attn_impl="blocked").to_json()


def _f32_state(plan, seed=0):
    params, axes = build_model(TCFG, "cpu").init(
        torch.Generator().manual_seed(seed), torch.float32)
    return TOPT.init_state(params, axes, plan.stages[0])


def _masked_batches(n=2, seed=0):
    """SyntheticLM tokens with a loss mask that keeps a drawn prefix of each
    row (``PackedCorpus`` fills every position of its rows, so its mask is
    all ones): the data ranks' rows, and the two halves of the sequence,
    count different numbers of tokens."""
    data = SyntheticLM(BatchSpec(GBS, SEQ, V), seed=seed)
    rng = np.random.default_rng(seed + 100)
    out = []
    for i in range(n):
        b = data.batch(i)
        keep = rng.integers(0, SEQ + 1, size=GBS)
        b["loss_mask"] = (np.arange(SEQ)[None, :]
                          < keep[:, None]).astype(np.float32)
        out.append(b)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def reference_masked(tmp_path_factory):
    """The reference's one-device ``make_train_step`` (f32, G 2, WO = OO =
    0.5) over the two masked batches from the port's seed-0 weights; its
    state after the first step saved by the reference's ``Checkpointer``.
    Returns (metrics per step, final state, the checkpoint's directory)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.configs.base import get_arch as jax_get_arch
    from repro.core.plan import Plan as JPlan
    from repro.launch.mesh import make_host_mesh
    from repro.lowering import lower_plan as jax_lower_plan
    from repro.models.zoo import build_model as jax_build_model
    from repro.training import optimizer as JOPT
    from repro.training.checkpoint import Checkpointer as JCheckpointer
    from repro.training.step import make_train_step as jax_make_train_step

    d = tmp_path_factory.mktemp("ref_ckpt")
    cfg = jax_get_arch(ARCH).reduced()
    plan = JPlan.from_json(_ref_plan_json())
    params, _ = build_model(TCFG, "cpu").init(torch.Generator().manual_seed(0),
                                              torch.float32)
    params = {n: jnp.asarray(v)
              for n, v in bridge.params_to_numpy(params).items()}
    mesh = make_host_mesh(1, 1)
    metrics = []
    with compat.set_mesh(mesh):
        low = jax_lower_plan(cfg, None, plan, mesh)
        st = low.stages[0]
        low = dataclasses.replace(low, stages=(dataclasses.replace(
            st, exec_cfg=st.exec_cfg.replace(compute_dtype=jnp.float32)),))
        step = jax_make_train_step(jax_build_model(cfg), plan, mesh,
                                   donate=False, lowered=low)
        state = jax.device_put(
            JOPT.init_state(params, low.axes_table, plan.stages[0]),
            low.state_shardings())
        for i, b in enumerate(_masked_batches()):
            if i == 1:
                JCheckpointer(d).save(1, state, {"arch": cfg.name})
            state, m = step.fn(state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        state = jax.tree.map(np.asarray, state)
    return metrics, state, d


def _whole(v):
    return np.asarray(bridge._joined(v), np.float64)


def _hold(metrics, state, want_metrics, want_state):
    """The f32 tolerances of the module docstring; split leaves joined, so
    states split by other WO/OO compare."""
    assert len(metrics) == len(want_metrics)
    for t, w in zip(metrics, want_metrics):
        np.testing.assert_allclose(t["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], w["grad_norm"], rtol=1e-4)
    for e in ("params", "master", "mu", "nu"):
        assert set(state[e]) == set(want_state[e]), e
        for n, v in want_state[e].items():
            got, want = _whole(state[e][n]), _whole(v)
            if e in ("params", "master"):
                err = np.abs(got - want)
                assert err.max() <= LR / 2 and err.mean() <= 1e-6, \
                    (e, n, float(err.max()), float(err.mean()))
            else:
                rel = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert rel <= MOMENT_RTOL, (e, n, float(rel))


def test_a_reference_checkpoint_restores_in_the_port_and_steps_on(
        reference_masked):
    """The reference's state after step 1 (WO = OO = 0.5) restores onto a
    one-device plan without host splits; the port's step 2 from it against
    the reference's step 2."""
    metrics, want, d = reference_masked
    plan = Plan.from_json(_ref_plan_json()).replace(
        stages=(Plan.from_json(_ref_plan_json()).stages[0].replace(
            wo=0.0, oo=0.0),))
    step, state, _ = Checkpointer(d).restore(place=StatePlacement(
        TCFG, plan, None, "cpu", param_dtype=torch.float32))
    assert step == 1 and int(state["step"]) == 1
    assert not TOPT.is_split(state["master"]["layers/attn/wq"])
    fn = TSTEP.make_train_step(build_model(TCFG, "cpu"), plan).fn
    state, m = fn(state, _torch_batch(_masked_batches()[1]))
    _hold([{k: float(v) for k, v in m.items()}], bridge.train_state_to_numpy(
        state), metrics[1:], want)


# -- multi-rank worlds over gloo ----------------------------------------------

ONE = single_stage_plan(TCFG.num_layers, dp=1, tp=1, micro_batch=GBS // G,
                        grad_accum=G, zero=1, attn_impl="blocked")


def _single(dp, tp, **kw):
    return single_stage_plan(TCFG.num_layers, dp=dp, tp=tp,
                             micro_batch=GBS // (G * dp), grad_accum=G,
                             attn_impl="blocked", **{"zero": 1, **kw})


def _piped(S, dp):
    return Plan(grad_accum=G, attn_impl="blocked", stages=tuple(
        StageConfig(layers=TCFG.num_layers // S, micro_batch=GBS // (G * dp),
                    dp=dp, tp=1, zero=1, ckpt_layers=0) for _ in range(S)))


# world 2: the masked loss, and the loop's decisions on every rank
MASKED = {"dp2": _single(2, 1), "tp2_sp": _single(1, 2,
                                                  sequence_parallel=True),
          "s2": _piped(2, 1)}
LOOPS = {"dp2": _single(2, 1), "s2": _piped(2, 1)}
# world 4: a dp 2 x tp 2 ZeRO 1 checkpoint placed onto other plans
ELASTIC_FROM = _single(2, 2)
ELASTIC_TO = {"dp4_z2": _single(4, 1, zero=2), "s2_dp2": _piped(2, 2)}


def _mesh(plan):
    st = plan.stages[0]
    return make_plan_mesh(st.dp, st.tp, "cpu", plan.num_stages)


def _rank_state(plan, mesh, seed=0):
    """This rank's cut of the one-process f32 state of ``seed``."""
    return bridge.shard_train_state(
        bridge.train_state_to_numpy(_f32_state(ONE, seed)), TCFG, plan, mesh,
        param_dtype=torch.float32)


def _rank_step(plan, mesh):
    model = build_model(TCFG, "cpu")
    if plan.num_stages > 1:
        from repro_torch.parallel.pipeline import make_pipeline_train_step
        return make_pipeline_train_step(model, plan, mesh).fn
    return TSTEP.make_train_step(model, plan, mesh=mesh).fn


def _place(plan, mesh):
    return StatePlacement(TCFG, plan, mesh, "cpu", param_dtype=torch.float32)


def _masked_case(plan):
    mesh = _mesh(plan)
    state, fn = _rank_state(plan, mesh), _rank_step(plan, mesh)
    metrics = []
    for b in _masked_batches():
        state, m = fn(state, _torch_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics,
                state=bridge.gather_train_state(state, TCFG, plan, mesh))


def _loop_case(name, kind, ckdir):
    """Four steps of ``TrainLoop`` (checkpoints every 2) on every rank:
    ``clean``; ``nan``: one rank's ``embed/w`` poisoned before step 3 (a
    data rank's, or the first stage's, whose loss the last stage computes);
    ``fault``: every rank fails at step 3 once.  Returns rank 0's gathered
    final state and every rank's (rollbacks, restarts, losses)."""
    plan = LOOPS[name]
    mesh = _mesh(plan)
    fn = _rank_step(plan, mesh)
    batches = _batches(4)
    cur, hits = {}, []
    poison_rank = 1 if name == "dp2" else 0

    def step_fn(state, batch):
        if kind == "nan" and cur["i"] == 3 and not hits \
                and dist.get_rank() == poison_rank:
            hits.append(1)
            state["params"]["embed/w"].fill_(float("nan"))
        return fn(state, batch)

    def fault(i):
        if kind == "fault" and i == 3 and not hits:
            hits.append(1)
            raise RuntimeError("simulated node failure")

    def batch(i):
        cur["i"] = i
        return _torch_batch(batches[i])

    loop = TrainLoop(step_fn, _rank_state(plan, mesh), batch,
                     ckpt_dir=str(pathlib.Path(ckdir) / f"{name}_{kind}"),
                     cfg=LoopConfig(total_steps=4, ckpt_every=2),
                     place=_place(plan, mesh), fault_hook=fault)
    stats = loop.run()
    mine = (stats.rollbacks, stats.restarts, stats.losses)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    full = bridge.gather_train_state(loop.state, TCFG, plan, mesh)
    return dict(ranks=every, state=full)


def _elastic(ckdir):
    """One step of the dp 2 x tp 2 ZeRO 1 plan, saved (rank 0 writes the
    gathered state); then each target plan on the same world: a fresh
    state (seed 1), the checkpoint resumed into it in place, one step."""
    ck = pathlib.Path(ckdir) / "elastic"
    mesh = _mesh(ELASTIC_FROM)
    state = _rank_state(ELASTIC_FROM, mesh)
    state, _ = _rank_step(ELASTIC_FROM, mesh)(state,
                                              _torch_batch(_batches(1)[0]))
    Checkpointer(ck).save(1, state, {"arch": TCFG.name},
                          place=_place(ELASTIC_FROM, mesh))
    dist.barrier()
    out = {}
    for name, plan in ELASTIC_TO.items():
        mesh = _mesh(plan)
        live = _rank_state(plan, mesh, seed=1)
        step, live, _ = TrainLoop.resume(ck, _place(plan, mesh), into=live)
        live, m = _rank_step(plan, mesh)(live, _torch_batch(_batches(2)[1]))
        out[name] = dict(step=step,
                         metrics=[{k: float(v) for k, v in m.items()}],
                         state=bridge.gather_train_state(live, TCFG, plan,
                                                         mesh))
    return out


def _batches(n):
    data = SyntheticLM(BatchSpec(GBS, SEQ, V))
    return [data.batch(i) for i in range(n)]


def _rank_main(out: str, ckdir: str) -> None:
    rank, world, _ = init_distributed("cpu")
    results = {}
    try:
        if world == 2:
            results["masked"] = {n: _masked_case(p)
                                 for n, p in MASKED.items()}
            results["loops"] = {(n, k): _loop_case(n, k, ckdir)
                                for n in LOOPS
                                for k in ("clean", "nan", "fault")}
        else:
            results["elastic"] = _elastic(ckdir)
    finally:
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()


def _start_world(world: int, out: pathlib.Path, ckdir: pathlib.Path):
    port = train_launch._free_port()
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT / 'tests')!r}]; import test_torch_loop as T; "
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


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory):
    """The worlds of 2 and 4 ranks, started with the module so that they
    run beside its other tests; ``worlds(w)`` waits for world w and returns
    rank 0's results and the checkpoint directory."""
    tmp = tmp_path_factory.mktemp("worlds")
    procs = {w: _start_world(w, tmp / f"ws{w}.pkl", tmp / f"ck{w}")
             for w in (2, 4)}
    done = {}

    def get(w):
        if w not in done:
            logs = []
            for p in procs[w]:
                try:
                    logs.append(p.communicate(timeout=300)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    logs.append(p.communicate()[0])
            assert all(p.returncode == 0 for p in procs[w]), \
                "\n".join(logs)[-4000:]
            with open(tmp / f"ws{w}.pkl", "rb") as f:
                done[w] = pickle.load(f), tmp / f"ck{w}"
        return done[w]

    yield get
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("case", list(MASKED))
def test_masked_loss_is_the_global_micro_batch_mean(worlds, reference_masked,
                                                    case):
    """Under dp 2 (each data rank's rows count other numbers of tokens),
    tp 2 with SP (the mask split along the sequence as the labels) and S 2,
    the masked loss and the state after two steps against the reference's
    one-device ``make_train_step``: the global micro-batch's masked
    mean."""
    metrics, want, _ = reference_masked
    got = worlds(2)[0]["masked"][case]
    _hold(got["metrics"], got["state"], metrics, want)


@pytest.mark.parametrize("case", list(LOOPS))
@pytest.mark.parametrize("kind", ["nan", "fault"])
def test_every_rank_takes_the_same_decision(worlds, case, kind):
    """A non-finite loss on one rank's shard (the loss is all-reduced over
    data and broadcast over the stages) rolls every rank back; a fault at
    the same step restarts every rank from the collective checkpoint; both
    end bit for bit where the uninterrupted loop ends."""
    loops = worlds(2)[0]["loops"]
    clean, got = loops[(case, "clean")], loops[(case, kind)]
    want = (1, 0) if kind == "nan" else (0, 1)
    assert all(r[:2] == want for r in got["ranks"]), got["ranks"]
    losses = [r[2] for r in got["ranks"]]
    assert all(x == losses[0] for x in losses)
    assert losses[0][-2:] == clean["ranks"][0][2][-2:]
    _assert_bitwise(got["state"], clean["state"], f"{case} {kind}")


def _one_process_from(ckdir, plan):
    """The one-process f32 step from the checkpoint in ``ckdir``, resumed
    into a state of ``plan``: (metrics, final state as numpy)."""
    live = _f32_state(plan, seed=2)
    step, live, _ = TrainLoop.resume(ckdir, StatePlacement(
        TCFG, plan, None, "cpu", param_dtype=torch.float32), into=live)
    assert step == 1
    fn = TSTEP.make_train_step(build_model(TCFG, "cpu"), plan).fn
    live, m = fn(live, _torch_batch(_batches(2)[1]))
    return [{k: float(v) for k, v in m.items()}], \
        bridge.train_state_to_numpy(live)


@pytest.fixture(scope="module")
def one_process_from_elastic(worlds):
    results, ckdir = worlds(4)
    return results["elastic"], _one_process_from(ckdir / "elastic", ONE)


@pytest.mark.parametrize("target", list(ELASTIC_TO))
def test_elastic_restore_onto_another_mesh(one_process_from_elastic, target):
    """dp 2 x tp 2 ZeRO 1 -> dp 4 ZeRO 2 and -> S 2 x dp 2: the restored
    state's step against the one-process step from the same checkpoint."""
    elastic, (want_m, want_s) = one_process_from_elastic
    got = elastic[target]
    assert got["step"] == 1
    _hold(got["metrics"], got["state"], want_m, want_s)


def test_elastic_restore_onto_one_process_with_host_splits(
        one_process_from_elastic, worlds):
    """The same checkpoint (no host split) onto one process with WO = OO =
    0.5: each optimizer leaf split by the target's stage."""
    _, (want_m, want_s) = one_process_from_elastic
    plan = ONE.replace(stages=(ONE.stages[0].replace(wo=0.5, oo=0.5),))
    got_m, got_s = _one_process_from(worlds(4)[1] / "elastic", plan)
    assert TOPT.is_split(got_s["master"]["layers/attn/wq"])
    _hold(got_m, got_s, want_m, want_s)
    manifest = Checkpointer(worlds(4)[1] / "elastic").manifest(1)
    assert (manifest["world"], manifest["rank"]) == (4, 0)


# -- the launcher ----------------------------------------------------------------


def _launch(tmp_path, *extra):
    d = tmp_path / "ck"
    rc = train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--steps", "4", "--ckpt-every", "2",
                            "--ckpt-dir", str(d), *extra])
    assert rc == 0
    return Checkpointer(d)


def test_launcher_checkpoints_through_the_loop(tmp_path, capsys):
    ck = _launch(tmp_path)
    out = capsys.readouterr().out
    assert ck.all_steps() == [2, 4]
    meta = ck.manifest(4)["meta"]
    assert meta["arch"] == TCFG.name
    assert Plan.from_json(meta["plan"]).stages[0].ckpt_layers == 2
    assert "# loop: rollback snapshot" in out and "rollbacks=0" in out
    assert "trained 4 steps" in out
    losses = [float(x) for x in
              out.split("# losses: ")[1].splitlines()[0].split()]
    _, state, _ = ck.restore(4)
    assert int(state["step"]) == 4 and len(losses) == 4


def test_launcher_on_two_ranks_writes_the_gathered_state_once(tmp_path):
    plan = single_stage_plan(TCFG.num_layers, dp=2, tp=1, micro_batch=2,
                             grad_accum=2, zero=1, attn_impl="pallas",
                             use_pallas=True)
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    ck = _launch(tmp_path, "--plan-json", str(path), "--nproc", "2")
    assert ck.all_steps() == [2, 4]
    assert not list(ck.dir.glob(".tmp_*"))
    manifest = ck.manifest(4)
    assert (manifest["world"], manifest["rank"]) == (2, 0)
    assert manifest["leaves"]["params::embed/w"]["shape"] == [V,
                                                              TCFG.d_model]
    assert json.loads(manifest["meta"]["plan"])["stages"][0]["dp"] == 2
