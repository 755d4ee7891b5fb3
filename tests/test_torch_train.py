"""Training parity of the PyTorch port with the JAX reference, on the CPU, at
reduced granite-3-8b (4 layers, d 128, 4 heads, 1 KV head, vocab 512).

The same weights (the reference's init, crossed through numpy by
``repro_torch.bridge``) and the same numpy-made batches go through both
packages.  On the CPU each kernel wrapper runs its plain version, so these
tests hold the port's algebra -- loss, every gradient, the remat and
offload segmentation, the optimizer with its host splits, the train step --
against the reference; ``chip_smoke.py`` holds the kernels against the same
plain versions on the card.

Tolerances:
- f32: loss 1e-5 relative; gradients and updated state 1e-4 of each
  tensor's largest value (the packages sum in other orders).
- bf16: loss 1e-2 relative.  Gradients: the mean difference from the
  reference's bf16 gradient within 3e-2 of the tensor's mean magnitude, and
  the error against the reference's f32 gradient at most 1.5x the
  reference's own bf16 error, in max and in mean.  bf16 rounds at other
  places in XLA and PyTorch, and the reference's own bf16 gradients of
  this model sit a few percent of each tensor's largest value from its f32
  ones, so no fixed share of the largest value separates a fault from
  that noise (the rule of ``ACCURACY_ROOM`` in chip_smoke.py).
- Within the port, every remat/offload case equals the run without remat
  bit for bit: recomputation repeats the same CPU ops on the same inputs.
- Optimizer: 1e-6 (the same f32 update formula); int8 compression bitwise.
- Train step, f32: params and master after two steps within half the
  learning rate of the reference's elementwise, and within 1e-6 on
  average.  Adam divides each gradient by its own magnitude, so on the few
  elements whose gradient is near zero the packages' ~1e-6 relative
  gradient difference moves the update by a visible share of lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs.base import ShapeConfig
from repro.configs.base import get_arch as jax_get_arch
from repro.core.plan import single_stage_plan as jax_plan
from repro.launch.mesh import make_host_mesh
from repro.lowering import lower_plan
from repro.models import decoder as JDEC
from repro.models.common import ExecConfig as JExecConfig
from repro.models.zoo import build_model as jax_build_model
from repro.parallel import compression as JCOMP
from repro.training import optimizer as JOPT
from repro.training.data import BatchSpec as JBatchSpec
from repro.training.data import SyntheticLM as JSyntheticLM
from repro.training.data import microbatched as jmicrobatched
from repro.training.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.core.plan import Plan, single_stage_plan
from repro_torch.launch import train as train_launch
from repro_torch.models import common as TC
from repro_torch.models import decoder as TDEC
from repro_torch.models.common import ExecConfig
from repro_torch.models.zoo import build_model
from repro_torch.parallel import compression as TCOMP
from repro_torch.training import optimizer as TOPT
from repro_torch.training.data import BatchSpec, SyntheticLM, microbatched
from repro_torch.training import step as TSTEP
from repro_torch.training.step import init_train_state, make_train_step

ARCH = "granite-3-8b"
JCFG = jax_get_arch(ARCH).reduced()
TCFG = get_arch(ARCH).reduced()
B, S = 2, 64
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
ACCURACY_ROOM = 1.5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_scaled(got, want, tol, what=""):
    """|got - want| <= tol * max|want| (per tensor)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _close_grad(got, want, truth, dtype, what):
    """A gradient against the reference's in ``dtype`` (and, in bf16,
    against the reference's f32 gradient ``truth``), as the module
    docstring states."""
    if dtype == "float32":
        return _close_scaled(got, want, GRAD_TOL[dtype], what)
    got = _np(got)
    diff = np.abs(got - want).mean()
    assert diff <= GRAD_TOL[dtype] * np.abs(want).mean(), (what, diff)
    e, e0 = np.abs(got - truth), np.abs(want - truth)
    assert e.max() <= ACCURACY_ROOM * e0.max(), (what, e.max(), e0.max())
    assert e.mean() <= ACCURACY_ROOM * e0.mean(), (what, e.mean(), e0.mean())


@pytest.fixture(scope="module")
def weights():
    """The reference's reduced-granite init in f32, as numpy."""
    jparams, _ = JDEC.init_lm(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    return {n: np.asarray(v) for n, v in jparams.items()}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    toks = rng.integers(0, TCFG.vocab_size, (B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jec(jdt, **kw):
    return JExecConfig(compute_dtype=jdt, attn_impl="blocked",
                       attn_kv_block=16, **kw)


def _tec(tdt, **kw):
    return ExecConfig(compute_dtype=tdt, attn_impl="blocked",
                      attn_kv_block=16, **kw)


@pytest.fixture(scope="module")
def jax_grads(weights, batch):
    """jax.value_and_grad of the reference's lm_loss, per dtype."""
    out = {}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for name, (jdt, _) in DT.items():
        p = {n: jnp.asarray(v).astype(jdt) for n, v in weights.items()}
        fn = jax.jit(jax.value_and_grad(
            lambda pp, bb, jdt=jdt: JDEC.lm_loss(pp, bb, JCFG,
                                                 _jec(jdt, ckpt_layers=0))))
        loss, g = fn(p, jb)
        out[name] = (float(loss), {n: np.asarray(v.astype(jnp.float32))
                                   for n, v in g.items()})
    return out


def _port_loss_and_grads(weights, batch, tdt, ec):
    params = bridge.params_from_numpy(weights, dtype=tdt)
    for t in params.values():
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = TDEC.lm_loss(params, tb, TCFG, ec)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


SEGMENTS = [(0, 0.0), (2, 0.0), (4, 0.0), (4, 0.5), (4, 1.0)]


@pytest.fixture(scope="module")
def port_no_remat(weights, batch):
    return {name: _port_loss_and_grads(weights, batch, tdt,
                                       _tec(tdt, ckpt_layers=0))
            for name, (_, tdt) in DT.items()}


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("ckpt,ao", SEGMENTS)
def test_segmented_layer_scan_loss_and_grads(weights, batch, jax_grads,
                                             port_no_remat, dtype, policy,
                                             ckpt, ao):
    """Every CKPT/AO split and remat policy: loss and every gradient against
    jax.value_and_grad(lm_loss), and bitwise equal to the port's run
    without remat."""
    _, tdt = DT[dtype]
    off = int(round(ao * ckpt))
    ec = _tec(tdt, ckpt_layers=ckpt, offload_layers=off, remat_policy=policy)
    before = TC.OFFLOADED_BYTES
    loss, grads = _port_loss_and_grads(weights, batch, tdt, ec)
    # the offload hook took the layer inputs of the offload segment only
    esize = torch.finfo(tdt).bits // 8
    assert TC.OFFLOADED_BYTES - before == off * B * S * TCFG.d_model * esize
    want_loss, want = jax_grads[dtype]
    assert abs(float(loss) - want_loss) <= LOSS_TOL[dtype] * abs(want_loss)
    assert set(grads) == set(want)
    for n, g in grads.items():
        assert g.dtype == tdt
        _close_grad(g, want[n], jax_grads["float32"][1][n], dtype, n)
    base_loss, base = port_no_remat[dtype]
    assert torch.equal(loss, base_loss)
    for n, g in grads.items():
        assert torch.equal(g, base[n]), n


def test_remat_reruns_the_forward_kernels_of_each_remat_layer(
        weights, batch, monkeypatch):
    """Non-reentrant checkpoint (early stop on) recomputes each remat'd
    layer's two norms and its attention: per loss and backward, flash
    forward L + ckpt, RMSNorm forward 2L + 1 + 2 ckpt, and one backward of
    each per forward of the saved graph (flash L, RMSNorm 2L + 1)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    calls = {"fa": 0, "fa_bwd": 0, "rn": 0, "rn_bwd": 0}

    def counted(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(FA, "flash_attention",
                        counted("fa", FA.flash_attention))
    monkeypatch.setattr(FA, "flash_attention_bwd",
                        counted("fa_bwd", FA.flash_attention_bwd))
    monkeypatch.setattr(RN, "rmsnorm", counted("rn", RN.rmsnorm))
    monkeypatch.setattr(RN, "rmsnorm_bwd", counted("rn_bwd", RN.rmsnorm_bwd))
    L, ckpt = TCFG.num_layers, 3
    ec = _tec(torch.float32, ckpt_layers=ckpt, offload_layers=1,
              remat_policy="full")
    _port_loss_and_grads(weights, batch, torch.float32, ec)
    assert calls == {"fa": L + ckpt, "fa_bwd": L,
                     "rn": 2 * L + 1 + 2 * ckpt, "rn_bwd": 2 * L + 1}


def test_unbind_gives_each_layer_no_full_size_gradient(weights):
    """unbind's backward stacks the per-layer gradients once; indexing w[i]
    would hand back a zero gradient of the whole stack per layer."""
    w = torch.zeros((4, 3, 5), requires_grad=True)
    layers = TC.unbind_layers({"w": w}, 4)
    assert [tuple(lp["w"].shape) for lp in layers] == [(3, 5)] * 4
    assert layers[2]["w"].grad_fn.name() == "UnbindBackward0"
    sum(lp["w"].sum() * (i + 1) for i, lp in enumerate(layers)).backward()
    assert torch.equal(w.grad[:, 0, 0], torch.tensor([1., 2., 3., 4.]))


@pytest.mark.parametrize("s", [1024, 600], ids=["chunked", "ragged"])
def test_chunked_xent_matches_reference(s):
    """Chunks of 512 recomputed in the backward, and the full-logits
    fallback when 512 does not divide S: value and gradients (f32)."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, s, 16), dtype=np.float32)
    w = rng.standard_normal((16, 50), dtype=np.float32)
    labels = rng.integers(0, 50, (2, s), dtype=np.int32)
    mask = (rng.random((2, s)) > 0.2).astype(np.float32)
    jfn = jax.value_and_grad(
        lambda hh, ww: JDEC.chunked_xent(hh, ww, jnp.asarray(labels),
                                         jnp.asarray(mask)), argnums=(0, 1))
    want, (wh, ww) = jfn(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = TDEC.chunked_xent(th, tw, torch.from_numpy(labels),
                            torch.from_numpy(mask))
    gh, gw = torch.autograd.grad(got, (th, tw))
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-6)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-7)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), atol=1e-6)


# -- optimizer --------------------------------------------------------------

SPLITS = [(0.0, 0.0), (0.5, 0.5), (1.0, 1.0), (0.5, 0.0), (0.0, 1.0)]


@pytest.mark.parametrize("wo,oo", SPLITS)
def test_adam_update_matches_reference(weights, wo, oo):
    """1 and 3 AdamW steps with the same gradients: the reference's split
    shapes, host parts on the CPU, values within 1e-6."""
    _, axes = JDEC.init_lm(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32,
                           abstract=True)
    jplan = jax_plan(JCFG.num_layers, dp=1, tp=1, micro_batch=1,
                     grad_accum=1, wo=wo, oo=oo)
    stage = jplan.stages[0]
    rng = np.random.default_rng(5)
    grads = {n: rng.standard_normal(v.shape, dtype=np.float32) * 0.01
             for n, v in weights.items()}
    mesh = make_host_mesh(1, 1)
    with compat.set_mesh(mesh):
        shardings = lower_plan(JCFG, None, jplan, mesh).state_shardings()
    # the reference places split host parts in host memory where the
    # backend has it
    jstate = jax.device_put(JOPT.init_state(
        {n: jnp.asarray(v).astype(jnp.bfloat16) for n, v in weights.items()},
        axes, stage), shardings)
    jupdate = jax.jit(lambda st, g: JOPT.adam_update(st, g, JOPT.AdamConfig(),
                                                     shardings))
    tparams = bridge.params_from_numpy(weights, dtype=torch.bfloat16)
    tstate = TOPT.init_state(tparams, axes, stage)
    acfg = TOPT.AdamConfig()
    for step in range(1, 4):
        jstate, jm = jupdate(jstate, {n: jnp.asarray(g)
                                      for n, g in grads.items()})
        jstate = jax.device_put(jstate, shardings)
        tstate, tm = TOPT.adam_update(
            tstate, {n: torch.from_numpy(g) for n, g in grads.items()}, acfg)
        if step not in (1, 3):
            continue
        assert int(tstate["step"]) == int(jstate["step"]) == step
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for e in ("master", "mu", "nu"):
            for n in weights:
                jl, tl = jstate[e][n], tstate[e][n]
                assert JOPT.is_split(jl) == TOPT.is_split(tl), (e, n)
                pairs = ([(jl["host"], tl["host"]), (jl["dev"], tl["dev"])]
                         if TOPT.is_split(tl) else [(jl, tl)])
                if TOPT.is_split(tl):
                    assert tl["host"].device.type == "cpu"
                for jx, tx in pairs:
                    assert tuple(tx.shape) == jx.shape, (e, n)
                    np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                               atol=1e-6, rtol=1e-6)
        # bf16 params within one bf16 step: a master within 1e-6 of a
        # rounding boundary may round either way
        for n in weights:
            np.testing.assert_allclose(_np(tstate["params"][n]),
                                       _np(jstate["params"][n]),
                                       rtol=2 ** -7, atol=1e-6)


def _sliced_run(weights, wo, oo, slice_elems, steps=2):
    """The state after ``steps`` AdamW updates of the reduced model's state
    (WO/OO splits as given) with fixed gradients, the update in slices of at
    most ``slice_elems`` elements; the grad norm clips nothing."""
    _, axes = JDEC.init_lm(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32,
                           abstract=True)
    stage = single_stage_plan(TCFG.num_layers, dp=1, tp=1, micro_batch=1,
                              grad_accum=1, wo=wo, oo=oo).stages[0]
    rng = np.random.default_rng(7)
    grads = {n: torch.from_numpy(
        rng.standard_normal(v.shape, dtype=np.float32) * 0.01)
        for n, v in weights.items()}
    state = TOPT.init_state(
        bridge.params_from_numpy(weights, dtype=torch.bfloat16), axes, stage)
    acfg = TOPT.AdamConfig(grad_clip=1e30)
    finest = TOPT.SLICE_ELEMS
    TOPT.SLICE_ELEMS = slice_elems
    try:
        for _ in range(steps):
            state, _ = TOPT.adam_update(state, grads, acfg)
    finally:
        TOPT.SLICE_ELEMS = finest
    return state


def _state_tensors(state):
    for e in ("params", "master", "mu", "nu"):
        for n, v in sorted(state[e].items()):
            yield from ((f"{e}/{n}/{k}", x) for k, x in sorted(
                v.items())) if isinstance(v, dict) else ((f"{e}/{n}", v),)


@pytest.mark.parametrize("wo,oo", [(0.0, 0.0), (0.5, 0.5)],
                         ids=["stacked", "wo_oo_split"])
def test_sliced_adam_update_is_bitwise_the_whole_leaf_update(weights, wo,
                                                             oo):
    """Adam is elementwise: the update walked in slices of the leading dim
    (here one row, or 64 elements, at a time) leaves every leaf -- whole,
    or both halves of a WO/OO split one -- bit for bit where the whole-leaf
    update does."""
    whole = dict(_state_tensors(_sliced_run(weights, wo, oo, 1 << 62)))
    sliced = dict(_state_tensors(_sliced_run(weights, wo, oo, 64)))
    assert whole.keys() == sliced.keys()
    if wo:
        assert any(k.endswith("/host") for k in whole)
    for k in whole:
        assert torch.equal(whole[k], sliced[k]), k


def test_sliced_adam_update_allocates_one_slice_at_most(weights):
    """The largest tensor that the update (grad norm included) allocates is
    one slice of a leaf, not a whole leaf: every op that is neither in
    place nor a view is recorded with its output's size."""
    from torch.utils._python_dispatch import TorchDispatchMode

    quiet = {"slice", "select", "view", "_unsafe_view", "alias", "detach",
             "as_strided", "expand", "t", "transpose", "lift_fresh",
             "_to_copy_noop"}

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if not name.endswith("_") and name not in quiet:
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(t, torch.Tensor):
                        Largest.most = max(Largest.most, t.numel())
            return out

    _, axes = JDEC.init_lm(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32,
                           abstract=True)
    stage = single_stage_plan(TCFG.num_layers, dp=1, tp=1, micro_batch=1,
                              grad_accum=1).stages[0]
    grads = {n: torch.full(v.shape, 1e-3) for n, v in weights.items()}
    largest = {}
    for elems in (1 << 62, 64):
        state = TOPT.init_state(
            bridge.params_from_numpy(weights, dtype=torch.bfloat16), axes,
            stage)
        TOPT.SLICE_ELEMS, finest = elems, TOPT.SLICE_ELEMS
        try:
            Largest.most = 0
            with Largest():
                TOPT.adam_update(state, grads, TOPT.AdamConfig())
            largest[elems] = Largest.most
            # the largest slice that this bound cuts
            slices = [(hi - lo) * (g.numel() // max(1, g.shape[0]))
                      if g.dim() else 1
                      for g in grads.values()
                      for lo, hi in TOPT.row_slices(g)]
        finally:
            TOPT.SLICE_ELEMS = finest
        assert largest[elems] <= max(slices), (elems, largest[elems])
    whole_leaf = max(g.numel() for g in grads.values())
    assert largest[1 << 62] == whole_leaf
    assert largest[64] < whole_leaf


def test_split_k_and_init_match_reference(weights):
    _, axes = JDEC.init_lm(jax.random.PRNGKey(0), JCFG, abstract=True)
    for n, v in weights.items():
        for r in (0.0, 0.25, 0.5, 1.0):
            assert TOPT.split_k(n, v.shape, axes, r) == \
                JOPT.split_k(n, v.shape, axes, r)
    assert TOPT.LAYER_AXES == ("layers", "layers1", "layers2")


def test_fake_compress_matches_reference_bitwise():
    rng = np.random.default_rng(11)
    grads = {"a": rng.standard_normal((64, 32), dtype=np.float32),
             # exact halves of the scale: round half to even in both
             "b": (np.arange(-254, 255, dtype=np.float32) / 2.0)}
    want = JCOMP.fake_compress({n: jnp.asarray(g) for n, g in grads.items()})
    got = TCOMP.fake_compress({n: torch.from_numpy(g)
                               for n, g in grads.items()})
    for n in grads:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    res = {n: np.full_like(g, 0.01) for n, g in grads.items()}
    wg, wr = JCOMP.compress_with_feedback(
        {n: jnp.asarray(g) for n, g in grads.items()},
        {n: jnp.asarray(r) for n, r in res.items()})
    tg, tr = TCOMP.compress_with_feedback(
        {n: torch.from_numpy(g) for n, g in grads.items()},
        {n: torch.from_numpy(r) for n, r in res.items()})
    for n in grads:
        np.testing.assert_array_equal(tg[n].numpy(), np.asarray(wg[n]))
        np.testing.assert_array_equal(tr[n].numpy(), np.asarray(wr[n]))


def test_synthetic_data_matches_reference_bit_for_bit():
    spec = dict(global_batch=4, seq_len=32, vocab_size=TCFG.vocab_size)
    jd, td = JSyntheticLM(JBatchSpec(**spec), seed=3), \
        SyntheticLM(BatchSpec(**spec), seed=3)
    for step in (0, 5):
        jb, tb = jd.batch(step), td.batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k], jb[k])
        for k, v in microbatched(tb, 2).items():
            np.testing.assert_array_equal(v, jmicrobatched(jb, 2)[k])


# -- train step ---------------------------------------------------------------


def _jax_train(jplan, jparams, batches, compute_dtype):
    """The reference's make_train_step on a 1 x 1 host mesh, its exec config
    at ``compute_dtype``; returns (metrics per step, final state)."""
    mesh = make_host_mesh(1, 1)
    model = jax_build_model(JCFG)
    with compat.set_mesh(mesh):
        low = lower_plan(JCFG, None, jplan, mesh)
        st = low.stages[0]
        low = dataclasses.replace(low, stages=(dataclasses.replace(
            st, exec_cfg=st.exec_cfg.replace(compute_dtype=compute_dtype)),))
        step = jax_make_train_step(model, jplan, mesh, donate=False,
                                   lowered=low)
        state = jax.device_put(
            JOPT.init_state(jparams, low.axes_table, jplan.stages[0]),
            low.state_shardings())
        metrics = []
        for b in batches:
            state, m = step.fn(state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def _port_train(plan, tparams, batches):
    model = build_model(TCFG, "cpu")
    _, axes = model.init(torch.Generator().manual_seed(0))
    step = make_train_step(model, plan)
    state = TOPT.init_state(tparams, axes, plan.stages[0])
    metrics = []
    for b in batches:
        state, m = step.fn(state, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def _batches(n, gbs=4, seq=S, seed=0):
    data = SyntheticLM(BatchSpec(global_batch=gbs, seq_len=seq,
                                 vocab_size=TCFG.vocab_size), seed=seed)
    return [data.batch(i) for i in range(n)]


def test_train_step_matches_reference_and_state_round_trips(weights):
    """G = 2 micro-batches, ckpt 2 with one offloaded layer, WO = OO = 0.5,
    two steps in f32: loss per step, grad norm, params and master against
    the reference's make_train_step; then the state through the bridge."""
    jplan = jax_plan(JCFG.num_layers, dp=1, tp=1, micro_batch=2,
                     grad_accum=2, zero=1, ckpt_layers=2, wo=0.5, oo=0.5,
                     ao=0.5, attn_impl="blocked",
                     grad_compression=True)
    batches = _batches(2)
    jm, jstate = _jax_train(jplan, {n: jnp.asarray(v)
                                    for n, v in weights.items()},
                            batches, jnp.float32)
    plan = Plan.from_json(jplan.to_json())
    tm, tstate = _port_train(plan, bridge.params_from_numpy(weights),
                             batches)
    for j, t in zip(jm, tm):
        assert t["step"] == j["step"]
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
    lr = TOPT.AdamConfig().lr

    def close_update(got, want, what):
        err = np.abs(_np(got) - _np(want))
        assert err.max() <= lr / 2 and err.mean() <= 1e-6, \
            (what, err.max(), err.mean())

    for n in weights:
        close_update(tstate["params"][n], jstate["params"][n], n)
        jl, tl = jstate["master"][n], tstate["master"][n]
        assert TOPT.is_split(tl) == JOPT.is_split(jl), n
        if TOPT.is_split(tl):
            for part in ("host", "dev"):
                close_update(tl[part], jl[part], f"{n}/{part}")
        else:
            close_update(tl, jl, n)
    # the bridge: the reference's state crosses into the port's layout, and
    # the port's state survives a round trip exactly
    as_np = jax.tree.map(lambda x: np.asarray(x), jstate)
    crossed = bridge.train_state_from_numpy(as_np, param_dtype=torch.float32)
    back = bridge.train_state_to_numpy(bridge.train_state_from_numpy(
        bridge.train_state_to_numpy(tstate), param_dtype=torch.float32))
    assert crossed["step"].dtype == torch.int32 and int(crossed["step"]) == 2
    assert back["step"].dtype == np.int32
    ref = bridge.train_state_to_numpy(tstate)
    for e in ("params", "master", "mu", "nu"):
        assert set(crossed[e]) == set(tstate[e])
        for n, v in ref[e].items():
            got = back[e][n]
            if isinstance(v, dict):
                assert crossed[e][n]["host"].dtype == torch.float32
                for part in ("host", "dev"):
                    np.testing.assert_array_equal(got[part], v[part])
            else:
                np.testing.assert_array_equal(got, v)


def test_tuned_plan_executes_in_the_port_as_in_the_reference(weights):
    """The torch twin of test_system.py::test_tune_then_execute_reduced: the
    port's tuner, given the reference's hardware spec, gives the reference
    tuner's plan for 16 devices byte for byte; its knobs (zero, ckpt, oo,
    ao) run on the reduced config in both packages (bf16, one step), and
    the losses agree."""
    from repro.core.hardware import V5E
    from repro.core.tuner import tune as jax_tune
    from repro_torch.configs.base import ShapeConfig as TShapeConfig
    from repro_torch.core.hardware import HardwareSpec
    from repro_torch.core.tuner import tune
    jrep = jax_tune(jax_get_arch(ARCH), ShapeConfig("t", 4096, 32, "train"),
                    16, space="mist", stage_counts=(1,), grad_accums=(4,))
    rep = tune(get_arch(ARCH), TShapeConfig("t", 4096, 32, "train"), 16,
               space="mist", stage_counts=(1,), grad_accums=(4,),
               hw=HardwareSpec(**dataclasses.asdict(V5E)))
    assert rep.plan is not None
    assert rep.plan.to_json() == jrep.plan.to_json()
    tuned = rep.plan.stages[0]
    jplan = jax_plan(JCFG.num_layers, dp=1, tp=1, micro_batch=2,
                     grad_accum=2, zero=tuned.zero,
                     ckpt_layers=min(tuned.ckpt_layers, JCFG.num_layers),
                     oo=tuned.oo, ao=tuned.ao)
    plan = Plan.from_json(jplan.to_json())
    assert plan.to_json() == jplan.to_json()
    batches = _batches(1)
    jm, _ = _jax_train(jplan, {n: jnp.asarray(v).astype(jnp.bfloat16)
                               for n, v in weights.items()},
                       batches, jnp.bfloat16)
    tm, _ = _port_train(plan, bridge.params_from_numpy(
        weights, dtype=torch.bfloat16), batches)
    assert np.isfinite(tm[0]["loss"])
    np.testing.assert_allclose(tm[0]["loss"], jm[0]["loss"],
                               rtol=LOSS_TOL["bfloat16"])
    np.testing.assert_allclose(tm[0]["grad_norm"], jm[0]["grad_norm"],
                               rtol=5e-2)


def test_train_step_makes_no_whole_bf16_gradient():
    """The step takes its gradients through the sink (``GradSink``): no
    param is an autograd leaf (every ``.grad`` stays None), no stacked
    param is unbound, and no op makes a bf16 tensor of a stacked param's
    whole shape (``unbind``'s backward would stack one)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    model = build_model(TCFG, "cpu")
    plan = single_stage_plan(TCFG.num_layers, dp=1, tp=1, micro_batch=1,
                             grad_accum=2, zero=1, ckpt_layers=2, ao=0.5,
                             attn_impl="blocked")
    state = init_train_state(model, plan, torch.Generator().manual_seed(0))
    whole = {tuple(p.shape) for n, p in state["params"].items()
             if n.startswith("layers/")}
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name
            if name == "aten::unbind":
                seen.append(name)
            elif not name.endswith("_"):    # in place: the update's writes
                seen.extend(name for t in tree_flatten(out)[0]
                            if isinstance(t, torch.Tensor)
                            and t.dtype == torch.bfloat16
                            and tuple(t.shape) in whole)
            return out

    step = make_train_step(model, plan)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, gbs=2)[0].items()}
    with Record():
        state, m = step.fn(state, batch)
    assert seen == []
    assert torch.isfinite(m["loss"]) and int(m["step"]) == 1
    assert all(p.grad is None and not p.requires_grad
               for p in state["params"].values())


def test_init_train_state_splits_by_the_stage(monkeypatch):
    model = build_model(TCFG, "cpu")
    plan = Plan.from_json(jax_plan(TCFG.num_layers, dp=1, tp=1,
                                   micro_batch=1, grad_accum=1, wo=0.5,
                                   oo=1.0).to_json())
    state = init_train_state(model, plan, torch.Generator().manual_seed(0))
    wq = state["master"]["layers/attn/wq"]
    assert tuple(wq["host"].shape)[0] == 2 and tuple(wq["dev"].shape)[0] == 2
    assert torch.equal(wq["host"], state["params"]["layers/attn/wq"][:2]
                       .float())
    assert tuple(state["mu"]["layers/attn/wq"]["dev"].shape)[0] == 0
    assert not TOPT.is_split(state["master"]["embed/w"])
    assert state["params"]["embed/w"].dtype == torch.bfloat16


# -- launcher -----------------------------------------------------------------


def test_train_launcher_smoke_on_cpu(capsys):
    assert train_launch.main(["--arch", "granite-3-8b", "--smoke",
                              "--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "trained 2 steps" in out and "on cpu" in out


def test_train_launcher_cuts_depth_and_reads_a_plan(tmp_path, capsys,
                                                     monkeypatch):
    """``--layers`` and ``--plan-json`` as chip_smoke.py passes them: the
    model has the cut depth and the step runs the plan's knobs."""
    plan = single_stage_plan(2, dp=1, tp=1, micro_batch=1, grad_accum=2,
                             ckpt_layers=1, ao=1.0, wo=0.5, oo=0.5,
                             attn_impl="pallas", use_pallas=True)
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    seen = {}
    real = TSTEP.make_train_step

    def spy(model, p, *a, **kw):
        seen["layers"], seen["plan"] = model.cfg.num_layers, p
        return real(model, p, *a, **kw)

    monkeypatch.setattr(TSTEP, "make_train_step", spy)
    assert train_launch.main(["--arch", "granite-3-8b", "--smoke", "--layers",
                              "2", "--plan-json", str(path), "--steps", "1",
                              "--seq", "32", "--global-batch", "2",
                              "--device", "cpu"]) == 0
    assert seen["layers"] == 2 and seen["plan"] == plan
    assert "trained 1 steps" in capsys.readouterr().out
