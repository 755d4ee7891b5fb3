"""Serving parity of the PyTorch port with the JAX reference, on reduced
granite-3-8b (4 layers, d 128, 4 heads, 1 KV head).

The same weights (the reference's init, crossed through numpy by
``repro_torch.bridge``) and the same numpy-made tokens go through both
packages.  The reference runs its Pallas flash kernel in interpret mode,
as its own tests do; the port runs its plain versions (CPU tensors).

- f32: prefill logits and caches, then a greedy decode loop -- logits at
  1e-4 and tokens identical (the two packages differ by ~1e-6 in f32, far
  below the smallest top-2 margin).
- bf16: teacher-forced prefill + decode logits at 3e-2.  bf16 rounds at
  other places in the two frameworks (the reference's own naive and Pallas
  paths differ by ~1e-2 on these logits), so greedy tokens may flip at
  near-ties and are not compared here.
- bf16 end to end: port ``generate()`` against the reference's, tokens
  compared under a margin rule: identical at every step before the first
  step whose reference top-2 margin is below 3e-2, with that coverage
  asserted so the test cannot pass vacuously.
"""
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
from repro.models import decoder as JDEC
from repro.models.common import ExecConfig as JExecConfig
from repro.models.zoo import build_model as jax_build_model
from repro.models.zoo import pad_caches as jax_pad_caches
from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.core.plan import single_stage_plan
from repro_torch.launch.serve import generate
from repro_torch.models import decoder as TDEC
from repro_torch.models.common import ExecConfig
from repro_torch.models.zoo import build_model, pad_caches

ARCH = "granite-3-8b"
B, PLEN, STEPS = 2, 8, 4
MARGIN = 3e-2
# seeds of the end-to-end test, picked so that every row's first two
# generated tokens have a reference top-2 margin of at least MARGIN
GEN_SEED, GEN_B, GEN = 35, 4, 6

JCFG = jax_get_arch(ARCH).reduced()
TCFG = get_arch(ARCH).reduced()


def _params(dtype):
    jparams, _ = JDEC.init_lm(jax.random.PRNGKey(0), JCFG, dtype=dtype)
    flat = {n: np.asarray(v.astype(jnp.float32)) for n, v in jparams.items()}
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return jparams, bridge.params_from_numpy(flat, dtype=tdtype)


def _execs(attn_impl, jdtype, tdtype):
    kw = dict(ckpt_layers=0, remat_policy="none", attn_impl=attn_impl,
              use_pallas=attn_impl == "pallas")
    return (JExecConfig(compute_dtype=jdtype, **kw),
            ExecConfig(compute_dtype=tdtype, **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if jnp.issubdtype(
        x.dtype, jnp.floating) else np.asarray(x)


def _jax_fns(jcfg, jec):
    prefill = jax.jit(lambda p, t: JDEC.lm_prefill(p, {"tokens": t}, jcfg,
                                                  jec, return_cache=True))
    decode = jax.jit(lambda p, t, c: JDEC.lm_decode(p, t, c, jcfg, jec))
    return prefill, decode


@pytest.mark.parametrize("attn_impl", ["naive", "pallas"])
def test_f32_prefill_and_greedy_decode_match_reference(attn_impl):
    jparams, tparams = _params(jnp.float32)
    jec, tec = _execs(attn_impl, jnp.float32, torch.float32)
    jprefill, jdecode = _jax_fns(JCFG, jec)
    toks = np.random.default_rng(0).integers(0, JCFG.vocab_size, (B, PLEN),
                                             dtype=np.int32)

    jl, jc = jprefill(jparams, jnp.asarray(toks))
    tl, tc = TDEC.lm_prefill(tparams, {"tokens": torch.from_numpy(toks)},
                             TCFG, tec, return_cache=True)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    for key in ("k", "v"):
        assert tc[key].shape == jc[key].shape
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_array_equal(_np(tc["pos"]), _np(jc["pos"]))

    jc, tc = jax_pad_caches(jc, STEPS), pad_caches(tc, STEPS)
    for step in range(STEPS):
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        ttok = tl[:, -1].argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), jtok, err_msg=f"{step}")
        jl, jc = jdecode(jparams, jnp.asarray(jtok)[:, None], jc)
        tl, tc = TDEC.lm_decode(tparams, ttok[:, None], tc, TCFG, tec)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4,
                                   err_msg=f"decode step {step}")
    np.testing.assert_array_equal(_np(tc["pos"]), _np(jc["pos"]))


@pytest.fixture(scope="module")
def bf16_setup():
    jparams, tparams = _params(jnp.bfloat16)
    jec, tec = _execs("pallas", jnp.bfloat16, torch.bfloat16)
    return jparams, tparams, jec, tec, _jax_fns(JCFG, jec)


def _teacher_forced(prefill, decode, params, toks, plen):
    """Logits (B, steps, V) of prefill over toks[:, :plen] then decode of
    toks[:, plen:] one at a time."""
    logits, caches = prefill(params, toks[:, :plen])
    caches = (jax_pad_caches if isinstance(toks, jax.Array)
              else pad_caches)(caches, toks.shape[1] - plen)
    out = [logits[:, -1]]
    for i in range(plen, toks.shape[1]):
        logits, caches = decode(params, toks[:, i:i + 1], caches)
        out.append(logits[:, -1])
    return np.stack([_np(x) for x in out], axis=1)


def test_bf16_teacher_forced_logits_match_reference(bf16_setup):
    jparams, tparams, _, tec, (jprefill, jdecode) = bf16_setup
    toks = np.random.default_rng(1).integers(0, JCFG.vocab_size,
                                             (B, PLEN + 3), dtype=np.int32)
    want = _teacher_forced(jprefill, jdecode, jparams, jnp.asarray(toks),
                           PLEN)
    with torch.inference_mode():
        got = _teacher_forced(
            lambda p, t: TDEC.lm_prefill(p, {"tokens": t}, TCFG, tec, True),
            lambda p, t, c: TDEC.lm_decode(p, t, c, TCFG, tec),
            tparams, torch.from_numpy(toks), PLEN)
    assert got.shape == want.shape == (B, 4, JCFG.vocab_size)
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=0)


def test_bf16_generate_matches_reference_under_margin_rule(bf16_setup):
    jparams, tparams, _, _, (jprefill, jdecode) = bf16_setup
    prompts = np.random.default_rng(GEN_SEED).integers(
        0, JCFG.vocab_size, (GEN_B, PLEN), dtype=np.int32)

    n = 1
    plan_kw = dict(dp=n, tp=1, micro_batch=1, grad_accum=1, zero=0,
                   ckpt_layers=0, attn_impl="pallas", use_pallas=True)
    mesh = make_host_mesh(n, 1)
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
    assert (first_low >= 2).all(), \
        f"margin rule covers too few steps: {first_low}"
    for row in range(GEN_B):
        np.testing.assert_array_equal(got[row, :first_low[row]],
                                      want[row, :first_low[row]],
                                      err_msg=f"row {row}")


def test_init_caches_match_reference_layout_and_padded_prefill():
    """``init_lm_caches`` has the reference's tree, shapes and dtypes, and
    a max_len cache with the prefill rows written into it equals the
    zero-padded prefill cache (``pad_caches``)."""
    jc = JDEC.init_lm_caches(JCFG, B, PLEN + STEPS)
    model = build_model(TCFG, "cpu")
    tc = model.init_caches(B, PLEN + STEPS)
    assert sorted(tc) == sorted(jc)
    for key in ("k", "v", "pos"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype), key
        assert not tc[key].any()
    _, tparams = _params(jnp.bfloat16)
    _, ec = _execs("pallas", jnp.bfloat16, torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, TCFG.vocab_size, (B, PLEN), dtype=np.int32))
    _, pre = model.prefill_fn(tparams, {"tokens": toks}, ec, True)
    for key in ("k", "v"):
        tc[key][:, :, :PLEN] = pre[key]
    padded = pad_caches(pre, STEPS)
    for key in ("k", "v"):
        assert torch.equal(tc[key], padded[key]), key
