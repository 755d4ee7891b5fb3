"""The int8 KV cache of the PyTorch port against the JAX reference, on the
CPU at reduced configs (granite-3-8b, zamba2-2.7b, qwen2-moe-a2.7b).

- ``quantize_kv`` / ``dequantize_kv`` bitwise to the reference on f32 and
  bf16 inputs that hold exact .5 ties (both round half to even) and
  all-zero rows (the 1e-8 scale floor).
- The cache tree: ``quantize_caches`` touches only the self-attention
  ``{k, v, pos}`` dicts, and with ``pad_caches`` (the scales padded along
  S) it gives the reference's tree bitwise.
- The vector ``cache_write`` (a position per row) bitwise to the
  reference's one-hot form, on bf16 and int8 buffers and f32 scales.
- The int8 decode against the bf16 decode of the same model, under the
  reference's rule (``tests/test_serve_correctness.py::
  test_int8_decode_tracks_bf16``): logits within 0.5, and the argmax
  unchanged wherever the bf16 top-2 margin exceeds twice the largest
  int8-bf16 logit difference.
- The port's int8 teacher-forced decode logits against the reference's at
  3e-2 (granite in bf16 as ``test_torch_serve.py`` holds it; zamba2 and
  qwen2-moe computing in f32: their bf16 logits carry rounding noise above
  3e-2, ``test_torch_hybrid.py``, and the MoE's routing flips at near-ties).
- The int8 ``generate()`` against the reference's under
  ``test_torch_serve.py``'s margin rule.
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
from repro.models import decoder as JDEC
from repro.models import hybrid as JHY
from repro.models import layers as JL
from repro.models.common import ExecConfig as JExecConfig
from repro.models.zoo import build_model as jax_build_model
from repro.models.zoo import pad_caches as jax_pad_caches
from repro.models.zoo import quantize_caches as jax_quantize_caches
from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.core.plan import single_stage_plan
from repro_torch.launch.serve import generate
from repro_torch.models import layers as TL
from repro_torch.models.common import ExecConfig
from repro_torch.models.zoo import build_model, pad_caches, quantize_caches

ARCHS = ("granite-3-8b", "zamba2-2.7b", "qwen2-moe-a2.7b")
B, PLEN, STEPS = 2, 8, 3
MARGIN = 3e-2
# the end-to-end test (granite, bf16): seed picked so that every row's
# first two generated tokens have a reference top-2 margin >= MARGIN
GEN_SEED, GEN_B, GEN = 17, 4, 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if jnp.issubdtype(
        x.dtype, jnp.floating) else np.asarray(x)


def _bits(x):
    """Raw bits of a tensor or array (f32 as uint32, bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.uint32) if x.dtype == torch.float32 \
            else x.numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want, what=""):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _tdtype(jdtype):
    return torch.float32 if jdtype == jnp.float32 else torch.bfloat16


# -- quantize / dequantize -----------------------------------------------------


def _quant_inputs(dtype):
    """(4, 3, 2, 16) values: random rows, rows of exact .5 ties (max-abs
    15.875 = 127 / 8, so the scale is 1/8 and x / scale = k + 0.5), and
    all-zero rows."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 2, 16)).astype(np.float32) * 3
    ties = (np.arange(16, dtype=np.float32) - 8 + 0.5) / 8
    ties[0] = 127 / 8
    x[1, :, 0] = ties
    x[1, :, 1] = -ties
    x[2] = 0.0
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        _tdtype(dtype))
    return jx, tx


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_quantize_and_dequantize_kv_bitwise_to_reference(dtype):
    jx, tx = _quant_inputs(dtype)
    jq, js = JL.quantize_kv(jx)
    tq, ts = TL.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _assert_bitwise(tq, jq, "codes")
    _assert_bitwise(ts, js, "scales")
    assert (ts[2] == np.float32(1e-8)).all()           # the floor
    # the ties round half to even: -6.5 -> -6, -5.5 -> -6, ..., 0.5 -> 0
    np.testing.assert_array_equal(tq[1, 0, 0, 1:9].numpy(),
                                  [-6, -6, -4, -4, -2, -2, 0, 0])
    for jdt in (jnp.float32, jnp.bfloat16):
        _assert_bitwise(TL.dequantize_kv(tq, ts, _tdtype(jdt)),
                        JL.dequantize_kv(jq, js, jdt), f"dequantize {jdt}")


def test_vector_cache_write_is_bitwise_the_reference():
    """A (B,) position vector: row pos[b] of slot b, every other row
    untouched, on bf16 and int8 buffers and f32 scales."""
    rng = np.random.default_rng(1)
    b, s, kv, hd = 3, 10, 2, 8
    pos = np.array([0, 7, 9], np.int32)
    jec, tec = JExecConfig(), ExecConfig()
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    for shape, dt in (((b, s, kv, hd), jnp.bfloat16),
                      ((b, s, kv, hd), jnp.int8),
                      ((b, s, kv), jnp.float32)):
        buf = rng.standard_normal(shape).astype(np.float32) * 50
        upd = rng.standard_normal((b, 1) + shape[2:]).astype(np.float32) * 50
        jbuf, jupd = (jnp.asarray(buf).astype(dt),
                      jnp.asarray(upd).astype(dt))
        tbuf, tupd = (torch.from_numpy(np.array(a)) if dt != jnp.bfloat16
                      else torch.from_numpy(np.array(
                          a.astype(jnp.float32))).bfloat16()
                      for a in (jbuf, jupd))
        want = JL.cache_write(jbuf, jupd, jpos, 1, jec)
        got = TL.cache_write(tbuf, tupd, tpos, 1, tec)
        assert got is tbuf                                   # in place
        _assert_bitwise(got, want, str(dt))


# -- the cache tree --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, tcfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    return jcfg, tcfg, jax_build_model(jcfg), build_model(tcfg, "cpu")


@functools.lru_cache(maxsize=None)
def _params(arch, jdtype):
    """The reference's f32 init rounded to ``jdtype``, and its bridged copy
    (made once; no test writes to them)."""
    jcfg = _models(arch)[0]
    init = JHY.init_hybrid if jcfg.family == "hybrid" else JDEC.init_lm
    jparams, _ = init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    jparams = {n: v.astype(jdtype) for n, v in jparams.items()}
    flat = {n: np.asarray(v.astype(jnp.float32)) for n, v in jparams.items()}
    return jparams, bridge.params_from_numpy(flat, dtype=_tdtype(jdtype))


def _execs(jdtype):
    kw = dict(ckpt_layers=0, remat_policy="none", ssd_chunk=16)
    return (JExecConfig(compute_dtype=jdtype, **kw),
            ExecConfig(compute_dtype=_tdtype(jdtype), **kw))


def _toks(cfg, seed, shape=(B, PLEN + STEPS)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k],
                                                           path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_quantize_and_pad_caches_match_reference(arch):
    """The prefill caches, quantized and padded, are the reference's tree
    bitwise (int8 codes, f32 scales padded along S, pos, the Mamba2 state
    untouched), and ``quantize_caches`` passes every other leaf through."""
    _, tcfg, jmodel, tmodel = _models(arch)
    jparams, tparams = _params(arch, jnp.float32)
    jec, tec = _execs(jnp.float32)
    toks = _toks(tcfg, 2, (B, PLEN))
    _, jc = jmodel.prefill_fn(jparams, {"tokens": jnp.asarray(toks)}, jec,
                              True)
    tc = bridge.caches_from_numpy(_np_tree(jc), dtype=torch.float32)
    tq = quantize_caches(tc)
    for path, leaf in _leaves(tc):
        if path[-1] not in ("k", "v"):
            assert _get(tq, path) is leaf, path            # passed through
    kv = [p for p, _ in _leaves(tq) if p[-1] in ("k", "v")]
    assert kv and all(_get(tq, p).dtype == torch.int8 for p in kv)
    want = jax_pad_caches(jax_quantize_caches(jc), STEPS)
    got = pad_caches(tq, STEPS)
    wl, gl = _leaves(want), _leaves(got)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert tuple(g.shape) == w.shape, path
        _assert_bitwise(g, w, str(path))
    for key in ("k_scale", "v_scale"):
        sc = [leaf for p, leaf in gl if p[-1] == key][0]
        assert sc.dtype == torch.float32
        assert sc.shape[-2] == PLEN + STEPS and not sc[..., PLEN:, :].any()


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(
        v.astype(jnp.float32)) if jnp.issubdtype(v.dtype, jnp.floating)
        else np.asarray(v) for k, v in tree.items()}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# -- the int8 decode ---------------------------------------------------------------


def _decode_logits(decode, params, caches, toks, start, steps):
    out = []
    for k in range(steps):
        lg, caches = decode(params, toks[:, start + k:start + k + 1], caches)
        out.append(_np(lg[:, -1]))
    return np.stack(out, 1), caches


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_tracks_bf16(arch):
    """The reference's rule on the port: decode writes stay int8 + f32
    scales, and the quantized logits track the bf16 decode's."""
    _, tcfg, _, model = _models(arch)
    params, _ = model.init(torch.Generator().manual_seed(0))
    ec = ExecConfig(ckpt_layers=0, remat_policy="none")
    toks = torch.from_numpy(_toks(tcfg, 3))
    pre = {"tokens": toks[:, :PLEN]}

    def decode(p, t, c):
        return model.decode_fn(p, t, c, ec)

    with torch.inference_mode():
        _, c16 = model.prefill_fn(params, pre, ec, True)
        g16, _ = _decode_logits(decode, params, pad_caches(c16, STEPS),
                                toks, PLEN, STEPS)
        _, craw = model.prefill_fn(params, pre, ec, True)
        c8 = pad_caches(quantize_caches(craw), STEPS)
        g8, c8_out = _decode_logits(decode, params, c8, toks, PLEN, STEPS)
    attn = c8_out.get("attn", c8_out)
    assert attn["k"].dtype == attn["v"].dtype == torch.int8
    assert attn["k_scale"].dtype == attn["v_scale"].dtype == torch.float32
    assert (attn["pos"] == PLEN + STEPS).all()
    err = np.max(np.abs(g16 - g8))
    assert 0 < err < 0.5, err
    top2 = np.sort(g16, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2.0 * err
    agree = g16.argmax(-1) == g8.argmax(-1)
    assert agree[decisive].all()
    assert decisive.any() or agree.mean() > 0.5


@functools.lru_cache(maxsize=None)
def _jax_fns(arch, jdtype):
    jmodel = _models(arch)[2]
    jec = _execs(jdtype)[0]
    prefill = jax.jit(lambda p, t: jmodel.prefill_fn(p, {"tokens": t}, jec,
                                                     True))
    decode = jax.jit(lambda p, t, c: jmodel.decode_fn(p, t, c, jec))
    return prefill, decode


def _teacher_forced_int8(prefill, decode, params, toks, plen, pad, quant):
    logits, caches = prefill(params, toks[:, :plen])
    caches = pad(quant(caches), toks.shape[1] - plen)
    out, _ = _decode_logits(decode, params, caches, toks, plen,
                            toks.shape[1] - plen)
    return np.concatenate([_np(logits[:, -1])[:, None], out], axis=1)


@pytest.mark.parametrize("arch,jdtype", [
    ("granite-3-8b", jnp.bfloat16), ("zamba2-2.7b", jnp.float32),
    ("qwen2-moe-a2.7b", jnp.float32)], ids=["granite-bf16", "zamba2-f32",
                                            "qwen2_moe-f32"])
def test_int8_teacher_forced_logits_match_reference(arch, jdtype):
    _, tcfg, _, tmodel = _models(arch)
    jparams, tparams = _params(arch, jdtype)
    tec = _execs(jdtype)[1]
    jprefill, jdecode = _jax_fns(arch, jdtype)
    toks = _toks(tcfg, 1)
    want = _teacher_forced_int8(jprefill, jdecode, jparams,
                                jnp.asarray(toks), PLEN, jax_pad_caches,
                                jax_quantize_caches)
    with torch.inference_mode():
        got = _teacher_forced_int8(
            lambda p, t: tmodel.prefill_fn(p, {"tokens": t}, tec, True),
            lambda p, t, c: tmodel.decode_fn(p, t, c, tec),
            tparams, torch.from_numpy(toks), PLEN, pad_caches,
            quantize_caches)
    assert got.shape == want.shape == (B, STEPS + 1, tcfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=0)


def test_int8_generate_matches_reference_under_margin_rule():
    arch = "granite-3-8b"
    jcfg, tcfg, jmodel, tmodel = _models(arch)
    jparams, tparams = _params(arch, jnp.bfloat16)
    prompts = np.random.default_rng(GEN_SEED).integers(
        0, jcfg.vocab_size, (GEN_B, PLEN), dtype=np.int32)
    plan_kw = dict(dp=1, tp=1, micro_batch=1, grad_accum=1, zero=0,
                   ckpt_layers=0, attn_impl="pallas", use_pallas=True,
                   kv_cache_dtype="int8")
    mesh = make_host_mesh(1, 1)
    with compat.set_mesh(mesh):
        want = np.asarray(jax_generate(
            jmodel, jparams, jnp.asarray(prompts), GEN, mesh,
            jax_plan(jcfg.num_layers, **plan_kw)))
    got = generate(tmodel, tparams, torch.from_numpy(prompts), GEN,
                   single_stage_plan(tcfg.num_layers, **plan_kw)).numpy()
    assert got.shape == want.shape == (GEN_B, GEN)

    # the reference's int8 top-2 margins, teacher-forced on its own tokens
    jprefill, jdecode = _jax_fns(arch, jnp.bfloat16)
    seq = jnp.asarray(np.concatenate([prompts, want[:, :-1]], axis=1))
    logits = _teacher_forced_int8(jprefill, jdecode, jparams, seq, PLEN,
                                  jax_pad_caches, jax_quantize_caches)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    low = (top2[..., 1] - top2[..., 0]) < MARGIN            # (B, GEN)
    first_low = np.where(low.any(1), low.argmax(1), GEN)
    assert (first_low >= 2).all(), \
        f"margin rule covers too few steps: {first_low}"
    for row in range(GEN_B):
        np.testing.assert_array_equal(got[row, :first_low[row]],
                                      want[row, :first_low[row]],
                                      err_msg=f"row {row}")
