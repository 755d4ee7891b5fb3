"""Serving parity of the PyTorch port with the JAX reference on reduced
zamba2-2.7b (8 Mamba2 layers in 2 groups of 4, d 128, 4 heads of 32, SSD
state 16, head_dim 16), on the CPU.

The same weights (the reference's init, crossed through numpy by
``repro_torch.bridge``) and the same numpy-made tokens and inputs go
through both packages.  The reference runs its Pallas SSD and flash
kernels in interpret mode where its path reaches them, as its own tests
do; the port runs its plain versions (CPU tensors).  The SSD chunk is 16,
so the 32-token prompts span two chunks and the state carries.

- f32: ``ssd_chunked`` and ``mamba2_mixer`` (prefill with the state, one
  decode step) at 2e-4 / 1e-4; whole-model prefill logits at 1e-4 and the
  greedy prefill + decode loop of ``generate`` with tokens identical, for
  ``use_pallas`` False and True.  (``generate`` itself runs the plan's bf16
  compute dtype, so f32 drives the model functions it calls.)
- bf16: teacher-forced logits held against the reference's f32 logits
  (the port's error at most 1.5x the reference's own bf16 error), and
  ``generate()`` against the reference's under the margin rule of
  ``test_torch_serve.py``, with a margin above that bf16 error.
- layout: init, caches, ``pad_caches`` and the bridge of nested caches.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs.base import get_arch as jax_get_arch
from repro.core.plan import single_stage_plan as jax_plan
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import generate as jax_generate
from repro.models import hybrid as JHY
from repro.models import ssm as JSSM
from repro.models.common import ExecConfig as JExecConfig
from repro.models.zoo import build_model as jax_build_model
from repro.models.zoo import pad_caches as jax_pad_caches
from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.core.plan import single_stage_plan
from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as SS
from repro_torch.launch.serve import generate
from repro_torch.models import hybrid as THY
from repro_torch.models import ssm as TSSM
from repro_torch.models.common import ExecConfig, layer, subtree
from repro_torch.models.zoo import build_model, pad_caches

ARCH = "zamba2-2.7b"
B, PLEN, STEPS, CHUNK = 2, 32, 3, 16
# the bf16 margin rule: tokens must agree while the reference's top-2
# margin is at least the size of the bf16 rounding noise of this model's
# logits (about 0.2-0.25 of a largest logit of about 4, see
# test_bf16_teacher_forced_logits_as_accurate_as_reference)
MARGIN = 0.25
# the end-to-end bf16 test: seed and shape picked so that every row's
# first three generated tokens have a reference top-2 margin >= MARGIN
GEN_SEED, GEN_B, GEN = 80, 2, 4

JCFG = jax_get_arch(ARCH).reduced()
TCFG = get_arch(ARCH).reduced()


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors must never reach the CUDA library."""
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel loader")
    monkeypatch.setattr(_build, "load_library", refuse)
    SS.LAUNCHES = 0
    yield
    assert SS.LAUNCHES == 0


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if jnp.issubdtype(
        x.dtype, jnp.floating) else np.asarray(x)


def _tdtype(jdtype):
    return torch.float32 if jdtype == jnp.float32 else torch.bfloat16


@functools.lru_cache(maxsize=None)
def _params(jdtype):
    """The reference's f32 init, rounded to ``jdtype``, and its bridged copy
    (made once per dtype; no test writes to them)."""
    if jdtype == jnp.float32:
        jparams, _ = JHY.init_hybrid(jax.random.PRNGKey(0), JCFG,
                                     dtype=jnp.float32)
    else:
        jparams = {n: v.astype(jdtype)
                   for n, v in _params(jnp.float32)[0].items()}
    flat = {n: np.asarray(v.astype(jnp.float32)) for n, v in jparams.items()}
    return jparams, bridge.params_from_numpy(flat, dtype=_tdtype(jdtype))


def _execs(use_pallas, jdtype):
    kw = dict(ckpt_layers=0, remat_policy="none", ssd_chunk=CHUNK,
              attn_impl="pallas" if use_pallas else "naive",
              use_pallas=use_pallas)
    return (JExecConfig(compute_dtype=jdtype, **kw),
            ExecConfig(compute_dtype=_tdtype(jdtype), **kw))


@functools.lru_cache(maxsize=None)
def _jax_fns(jec):
    """The reference's jitted prefill (with caches) and decode, compiled
    once per exec config."""
    prefill = jax.jit(lambda p, t: JHY.hybrid_prefill(
        p, {"tokens": t}, JCFG, jec, return_cache=True))
    decode = jax.jit(lambda p, t, c: JHY.hybrid_decode(p, t, c, JCFG, jec))
    return prefill, decode


def _ssd_inputs(seed, b, s, h, p, n, dtype):
    rng = np.random.default_rng(seed)
    arrs = dict(
        xh=rng.standard_normal((b, s, h, p), dtype=np.float32),
        dt=np.log1p(np.exp(rng.standard_normal((b, s, h),
                                               dtype=np.float32))),
        a=-np.exp(rng.standard_normal((h,), dtype=np.float32)),
        bb=rng.standard_normal((b, s, h, n), dtype=np.float32),
        cc=rng.standard_normal((b, s, h, n), dtype=np.float32))
    low = ("xh", "bb", "cc")
    jx = {k: jnp.asarray(v).astype(dtype if k in low else jnp.float32)
          for k, v in arrs.items()}
    tx = {k: torch.from_numpy(v).to(_tdtype(dtype) if k in low
                                    else torch.float32)
          for k, v in arrs.items()}
    return jx, tx


# -- configs and weights -------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_copy_matches_reference(reduced):
    jcfg, tcfg = jax_get_arch(ARCH), get_arch(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for field in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "ssm_state", "ssm_expand", "ssm_head_dim", "ssm_groups",
                  "ssm_conv", "shared_attn_every", "norm_type", "act",
                  "mlp_gated", "tie_embeddings", "rope_theta"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert THY.group_shape(tcfg) == JHY.group_shape(jcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_names_shapes_bits(dtype):
    """The ``(groups, per, ...)`` stacked names cross bit for bit, and the
    port's own init has the reference's names, shapes, axes and scales."""
    jdtype = getattr(jnp, dtype)
    jparams, tparams = _params(jdtype)
    assert sorted(tparams) == sorted(jparams)
    for name, jv in jparams.items():
        tv = tparams[name]
        assert tuple(tv.shape) == jv.shape and tv.dtype == _tdtype(jdtype)
        np.testing.assert_array_equal(_np(tv), _np(jv), err_msg=name)
    _, jaxes = JHY.init_hybrid(None, JCFG, dtype=jnp.float32, abstract=True)
    own, taxes = THY.init_hybrid(TCFG, torch.Generator().manual_seed(0),
                                 torch.float32, "cpu")
    assert taxes == {n: tuple(a) for n, a in jaxes.items()}
    for name, jv in jparams.items():
        tv = own[name]
        assert tuple(tv.shape) == jv.shape, name
        jstd, tstd = float(np.std(_np(jv))), float(tv.std())
        if jstd == 0.0:   # ones / zeros init
            np.testing.assert_array_equal(tv.numpy(), _np(jv))
        else:             # normal init: same scale within sampling noise
            assert abs(tstd / jstd - 1.0) < 0.1, (name, tstd, jstd)


# -- the SSD and the Mamba2 mixer ----------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(dtype, with_h0):
    """The jnp route of ``ssd_chunked``, with its bf16 casts, and the final
    state it carries."""
    b, s, h, p, n = 2, 48, 4, 16, 8
    jdtype = getattr(jnp, dtype)
    jx, tx = _ssd_inputs(7, b, s, h, p, n, jdtype)
    h0 = np.random.default_rng(8).standard_normal((b, h, p, n),
                                                  dtype=np.float32) \
        if with_h0 else None
    want_y, want_h = JSSM.ssd_chunked(
        jx["xh"], jx["dt"], jx["a"], jx["bb"], jx["cc"], 16,
        h0=None if h0 is None else jnp.asarray(h0))
    got_y, got_h = TSSM.ssd_chunked(
        tx["xh"], tx["dt"], tx["a"], tx["bb"], tx["cc"], 16,
        h0=None if h0 is None else torch.from_numpy(h0))
    tol = 2e-4 if dtype == "float32" else 0.05
    assert got_y.dtype == tx["xh"].dtype and got_h.dtype == torch.float32
    np.testing.assert_allclose(_np(got_y), _np(want_y), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got_h), _np(want_h), atol=tol, rtol=tol)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain_route", "kernel_route"])
def test_mamba2_mixer_prefill_state_and_decode_match_reference(use_pallas):
    """One Mamba2 layer in f32: prefill with ``return_state`` (the port's
    kernel route also serves this, the reference's falls back to jnp), then
    one decode step from that cache."""
    jparams, tparams = _params(jnp.float32)
    jlp = {k[len("mamba/mixer/"):]: v[0, 1] for k, v in jparams.items()
           if k.startswith("mamba/mixer/")}
    tlp = layer(layer(subtree(subtree(tparams, "mamba"), "mixer"), 0), 1)
    jec, tec = _execs(use_pallas, jnp.float32)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, PLEN + 1, TCFG.d_model), dtype=np.float32)
    jmixer = jax.jit(lambda p, xx, c: JSSM.mamba2_mixer(
        p, xx, JCFG, jec, cache=c, return_state=c is None))
    jy, jc = jmixer(jlp, jnp.asarray(x[:, :PLEN]), None)
    ty, tc = TSSM.mamba2_mixer(tlp, torch.from_numpy(x[:, :PLEN]), TCFG, tec,
                               return_state=True)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4, rtol=1e-4)
    for key in ("conv", "ssm"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), atol=1e-4,
                                   rtol=1e-4, err_msg=key)
    jy, jc = jmixer(jlp, jnp.asarray(x[:, PLEN:]), jc)
    ty, tc = TSSM.mamba2_mixer(tlp, torch.from_numpy(x[:, PLEN:]), TCFG, tec,
                               cache=tc)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4, rtol=1e-4)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), atol=1e-4,
                                   rtol=1e-4, err_msg=key)


# -- the whole model -----------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain_route", "kernel_route"])
def test_f32_prefill_logits_and_greedy_loop_match_reference(use_pallas):
    jparams, tparams = _params(jnp.float32)
    jec, tec = _execs(use_pallas, jnp.float32)
    toks = np.random.default_rng(0).integers(0, JCFG.vocab_size, (B, PLEN),
                                             dtype=np.int32)
    # logits only: the reference's Pallas SSD route (interpret mode)
    want = JHY.hybrid_prefill(jparams, {"tokens": jnp.asarray(toks)}, JCFG,
                              jec)
    got = THY.hybrid_prefill(tparams, {"tokens": torch.from_numpy(toks)},
                             TCFG, tec)
    assert got.shape == want.shape == (B, 1, JCFG.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)

    # the greedy loop of generate(): prefill with caches, then decode
    jprefill, jdecode = _jax_fns(jec)
    jl, jc = jprefill(jparams, jnp.asarray(toks))
    tl, tc = THY.hybrid_prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                TCFG, tec, return_cache=True)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    jc, tc = jax_pad_caches(jc, STEPS), pad_caches(tc, STEPS)
    for step in range(STEPS):
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        ttok = tl[:, -1].argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), jtok, err_msg=f"{step}")
        jl, jc = jdecode(jparams, jnp.asarray(jtok)[:, None], jc)
        tl, tc = THY.hybrid_decode(tparams, ttok[:, None], tc, TCFG, tec)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4,
                                   err_msg=f"decode step {step}")
    np.testing.assert_array_equal(_np(tc["attn"]["pos"]),
                                  _np(jc["attn"]["pos"]))
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(_np(tc["mamba"][key]),
                                   _np(jc["mamba"][key]), atol=1e-4,
                                   rtol=1e-4, err_msg=key)


@pytest.fixture(scope="module")
def bf16_setup():
    jparams, tparams = _params(jnp.bfloat16)
    jec, tec = _execs(True, jnp.bfloat16)
    return jparams, tparams, tec, _jax_fns(jec)


def _teacher_forced(prefill, decode, params, toks, plen):
    """Logits (B, steps, V): prefill over toks[:, :plen], then decode of
    toks[:, plen:] one at a time."""
    logits, caches = prefill(params, toks[:, :plen])
    caches = (jax_pad_caches if isinstance(toks, jax.Array)
              else pad_caches)(caches, toks.shape[1] - plen)
    out = [logits[:, -1]]
    for i in range(plen, toks.shape[1]):
        logits, caches = decode(params, toks[:, i:i + 1], caches)
        out.append(logits[:, -1])
    return np.stack([_np(x) for x in out], axis=1)


def test_bf16_teacher_forced_logits_as_accurate_as_reference(bf16_setup):
    """bf16 prefill + decode logits, held against the exact function of the
    same bf16 weights (the reference in f32): the port's error is at most
    1.5x the reference's own bf16 error, in max and in mean.

    granite's absolute 3e-2 cannot hold here: this random-init hybrid
    amplifies rounding through its residual stream (hidden states grow to
    ~15), so the reference's own bf16 logits sit about 0.2 (max) from its
    f32 logits, of a largest logit of about 4."""
    jparams, tparams, tec, (jprefill, jdecode) = bf16_setup
    toks = np.random.default_rng(1).integers(0, JCFG.vocab_size,
                                             (B, PLEN + STEPS), dtype=np.int32)
    want = _teacher_forced(jprefill, jdecode, jparams, jnp.asarray(toks),
                           PLEN)
    jec32, _ = _execs(False, jnp.float32)
    truth = _teacher_forced(*_jax_fns(jec32),
                            {k: v.astype(jnp.float32)
                             for k, v in jparams.items()},
                            jnp.asarray(toks), PLEN)
    with torch.inference_mode():
        got = _teacher_forced(
            lambda p, t: THY.hybrid_prefill(p, {"tokens": t}, TCFG, tec,
                                            True),
            lambda p, t, c: THY.hybrid_decode(p, t, c, TCFG, tec),
            tparams, torch.from_numpy(toks), PLEN)
    assert got.shape == want.shape == (B, STEPS + 1, JCFG.vocab_size)
    assert np.isfinite(got).all()
    err, ref_err = np.abs(got - truth), np.abs(want - truth)
    assert err.max() <= 1.5 * ref_err.max(), (err.max(), ref_err.max())
    assert err.mean() <= 1.5 * ref_err.mean(), (err.mean(), ref_err.mean())


def test_bf16_generate_matches_reference_under_margin_rule(bf16_setup):
    jparams, tparams, _, (jprefill, jdecode) = bf16_setup
    prompts = np.random.default_rng(GEN_SEED).integers(
        0, JCFG.vocab_size, (GEN_B, PLEN), dtype=np.int32)
    plan_kw = dict(dp=1, tp=1, micro_batch=1, grad_accum=1, zero=0,
                   ckpt_layers=0, attn_impl="pallas", use_pallas=True)
    mesh = make_host_mesh(1, 1)
    with compat.set_mesh(mesh):
        want = np.asarray(jax_generate(
            jax_build_model(JCFG), jparams, jnp.asarray(prompts), GEN, mesh,
            jax_plan(JCFG.num_layers, **plan_kw)))
    got = generate(build_model(TCFG, "cpu"), tparams,
                   torch.from_numpy(prompts), GEN,
                   single_stage_plan(TCFG.num_layers, **plan_kw)).numpy()
    assert got.shape == want.shape == (GEN_B, GEN)

    # the reference's top-2 margins, teacher-forced on its own tokens
    seq = jnp.asarray(np.concatenate([prompts, want[:, :-1]], axis=1))
    logits = _teacher_forced(jprefill, jdecode, jparams, seq, PLEN)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    low = (top2[..., 1] - top2[..., 0]) < MARGIN            # (B, GEN)
    first_low = np.where(low.any(1), low.argmax(1), GEN)
    assert (first_low >= 3).all(), \
        f"margin rule covers too few steps: {first_low}"
    for row in range(GEN_B):
        np.testing.assert_array_equal(got[row, :first_low[row]],
                                      want[row, :first_low[row]],
                                      err_msg=f"row {row}")


# -- cache layout --------------------------------------------------------------


def test_init_caches_and_pad_caches_match_reference_layout():
    """``init_hybrid_caches`` has the reference's tree, shapes and dtypes;
    ``pad_caches`` pads only the attention k/v along S, as the reference's
    does; a max_len cache with the prefill written into it equals the
    padded prefill cache."""
    jc = JHY.init_hybrid_caches(JCFG, B, PLEN + STEPS)
    model = build_model(TCFG, "cpu")
    tc = model.init_caches(B, PLEN + STEPS)
    assert sorted(tc) == sorted(jc) == ["attn", "mamba"]
    for part in ("attn", "mamba"):
        assert sorted(tc[part]) == sorted(jc[part]), part
        for key, jv in jc[part].items():
            tv = tc[part][key]
            assert tuple(tv.shape) == jv.shape, (part, key)
            assert str(tv.dtype).split(".")[-1] == str(jv.dtype), (part, key)
            assert not tv.any()
    _, tparams = _params(jnp.bfloat16)
    _, tec = _execs(True, jnp.bfloat16)
    toks = np.random.default_rng(4).integers(0, TCFG.vocab_size, (B, PLEN),
                                             dtype=np.int32)
    _, pre = model.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)},
                              tec, True)
    padded = pad_caches(pre, STEPS)
    jpadded = jax_pad_caches(jax.tree.map(lambda t: jnp.asarray(_np(t)), pre,
                                          is_leaf=lambda t: isinstance(
                                              t, torch.Tensor)), STEPS)
    for part in ("attn", "mamba"):
        for key, jv in jpadded[part].items():
            assert tuple(padded[part][key].shape) == jv.shape, (part, key)
            np.testing.assert_array_equal(_np(padded[part][key]),
                                          np.asarray(jv), err_msg=key)
    for key in ("k", "v"):
        tc["attn"][key][:, :, :PLEN] = pre["attn"][key]
        assert torch.equal(tc["attn"][key], padded["attn"][key]), key
    for key in ("conv", "ssm"):
        assert padded["mamba"][key] is pre["mamba"][key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nested_caches_cross_bit_for_bit(dtype):
    jdtype = getattr(jnp, dtype)
    jparams, _ = _params(jdtype)
    jec, _ = _execs(False, jdtype)
    toks = np.random.default_rng(5).integers(0, JCFG.vocab_size, (B, PLEN),
                                             dtype=np.int32)
    _, jc = JHY.hybrid_prefill(jparams, {"tokens": jnp.asarray(toks)}, JCFG,
                               jec, return_cache=True)
    tree = jax.tree.map(lambda v: _np(v), jc)
    tc = bridge.caches_from_numpy(tree, dtype=_tdtype(jdtype))
    for part in ("attn", "mamba"):
        for key, jv in jc[part].items():
            tv = tc[part][key]
            assert tuple(tv.shape) == jv.shape, (part, key)
            assert str(tv.dtype).split(".")[-1] == str(jv.dtype), (part, key)
            np.testing.assert_array_equal(_np(tv), _np(jv), err_msg=key)
    back = bridge.caches_to_numpy(tc)
    for part in tree:
        for key in tree[part]:
            np.testing.assert_array_equal(back[part][key], tree[part][key])
