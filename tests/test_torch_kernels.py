"""The port's kernel modules against the JAX reference, on the CPU.

On a CPU tensor each wrapper runs its plain version (the Hopper kernels
run only on the card, where chip_smoke.py holds them against these same
plain versions).  Inputs are made with numpy from a seed and given to both
packages.  Tolerances are the reference's own (tests/test_kernels.py):
2e-5 in f32, 2e-2 / 3e-2 in bf16; for the SSD scan 2e-4 in f32 and 0.05
in bf16 (against the sequential oracle, whose sums run in another order).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd_scan as SS

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
RTOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pair(arr, dtype):
    """The same numpy array as a JAX array and a torch tensor of dtype."""
    return (jnp.asarray(arr).astype(getattr(jnp, dtype)),
            torch.from_numpy(arr).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors must never reach the CUDA library."""
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel loader")
    monkeypatch.setattr(_build, "load_library", refuse)
    FA.LAUNCHES = RN.LAUNCHES = SS.LAUNCHES = 0
    FA.BWD_LAUNCHES = RN.BWD_LAUNCHES = 0
    yield
    assert FA.LAUNCHES == 0 and RN.LAUNCHES == 0 and SS.LAUNCHES == 0
    assert FA.BWD_LAUNCHES == 0 and RN.BWD_LAUNCHES == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk", [(True, 64, 64), (False, 32, 96)])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)], ids=["g1", "g4"])
def test_plain_flash_matches_reference(dtype, causal, sq, sk, h, kv):
    rng = np.random.default_rng(0)
    b, hd = 2, 32
    arrs = [rng.standard_normal(s, dtype=np.float32) for s in
            ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrs)
    got = tops.attention(tq, tk, tv, causal=causal, impl="pallas",
                         q_block=32, kv_block=32)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops.attention(jq, jk, jv, causal=causal, impl="pallas",
                            q_block=32, kv_block=32)
    naive = jops.attention(jq, jk, jv, causal=causal, impl="naive")
    for want in (pallas, naive):
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype],
                                   rtol=RTOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_fwd_out_and_lse_match_reference(causal, dtype):
    rng = np.random.default_rng(1)
    bh, s, d, block = 3, 64, 32, 16
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((bh, s, d), dtype=np.float32), dtype)
        for _ in range(3))
    want_o, want_lse = jops._blocked_fwd(jq, jk, jv, causal, d ** -0.5, block)
    got_o, got_lse = FA.blocked_fwd(tq, tk, tv, causal, d ** -0.5, block)
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=ATOL[dtype],
                               rtol=RTOL[dtype])
    # lse is f32 in both; bf16 inputs differ only by the rounding of p
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), atol=2e-5,
                               rtol=2e-5)


def test_gqa_wrapper_lse_layout_and_ragged_keys():
    """flash_attention's (o, lse) in the kernel's layouts, at a key count
    no power of two divides (300): o matches the naive reference and lse is
    the (B, H, Sq) reshape of the broadcast blocked pass."""
    rng = np.random.default_rng(2)
    b, sq, sk, h, kv, hd = 2, 16, 300, 8, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))
    o, lse = FA.flash_attention(q, k, v, causal=False)
    assert o.shape == (b, sq, h, hd) and lse.shape == (b, h, sq)
    want = jops.attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                          jnp.asarray(v.numpy()), causal=False, impl="naive")
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    kx = k.repeat_interleave(h // kv, dim=2).permute(0, 2, 1, 3)
    vx = v.repeat_interleave(h // kv, dim=2).permute(0, 2, 1, 3)
    _, want_lse = jops._blocked_fwd(
        jnp.asarray(q.permute(0, 2, 1, 3).reshape(b * h, sq, hd).numpy()),
        jnp.asarray(kx.reshape(b * h, sk, hd).numpy()),
        jnp.asarray(vx.reshape(b * h, sk, hd).numpy()),
        False, hd ** -0.5, 300)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse).reshape(b, h, sq),
                               atol=2e-5, rtol=2e-5)


# the reference's own bf16 tolerance for its blocked backward
# (tests/test_kernels.py:59-62)
BWD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_bwd_matches_reference(causal, dtype):
    """blocked_bwd against the reference's _blocked_bwd on the same out, lse
    and dout: the same roundings (bf16 P and dS as product operands, f32
    dq sums across KV blocks)."""
    rng = np.random.default_rng(12)
    bh, s, d, block = 3, 64, 32, 16
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(rng.standard_normal((bh, s, d), dtype=np.float32), dtype)
        for _ in range(4))
    jo, jlse = jops._blocked_fwd(jq, jk, jv, causal, d ** -0.5, block)
    to = torch.from_numpy(np.array(_np(jo))).to(tq.dtype)
    tlse = torch.from_numpy(np.array(jlse))
    want = jops._blocked_bwd(jq, jk, jv, jo, jlse, jdo, causal, d ** -0.5,
                             block)
    got = FA.blocked_bwd(tq, tk, tv, to, tlse, tdo, causal, d ** -0.5, block)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv,sq,sk", [(8, 2, 48, 48), (4, 4, 40, 72)],
                         ids=["gqa4", "g1-ragged"])
def test_flash_attention_function_grads_match_reference(causal, h, kv, sq,
                                                        sk):
    """FlashAttention's gradients (plain versions on the CPU) against
    jax.grad of the reference's ops.attention(impl="pallas"), its Pallas
    forward in interpret mode with the blocked backward, in f32 at GQA
    shapes: 1e-3 (tests/test_kernels.py:121-125)."""
    import jax
    rng = np.random.default_rng(13)
    b, hd = 2, 32
    arrs = [rng.standard_normal(sh, dtype=np.float32) for sh in
            ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd),
             (b, sq, h, hd))]

    def jloss(q, k, v):
        o = jops.attention(q, k, v, causal=causal, impl="pallas",
                           q_block=16, kv_block=8)
        return jnp.sum(o * jnp.asarray(arrs[3]))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrs[:3]))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    o = tops.attention(tq, tk, tv, causal=causal, impl="pallas", q_block=16,
                       kv_block=8)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(arrs[3]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=1e-3)


def _bf16_step(x):
    """One bf16 step (ulp) at each value's magnitude."""
    ax = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(ax)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 128), (2, 5, 96)])
def test_rmsnorm_function_grads_match_reference(dtype, shape):
    """RMSNorm's dx and dscale (the plain backward on the CPU) against
    jax.grad of the reference's layers.norm, which the JAX model
    differentiates: f32 within 1e-5, bf16 within one bf16 step."""
    import jax
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import layers as JL
    jcfg = jax_get_arch("granite-3-8b").reduced().replace(d_model=shape[-1])
    rng = np.random.default_rng(14)
    x = rng.standard_normal(shape, dtype=np.float32)
    sc = 1 + 0.1 * rng.standard_normal(shape[-1:], dtype=np.float32)
    dy = rng.standard_normal(shape, dtype=np.float32)
    (jx, tx), (js, ts), (jdy, tdy) = (_pair(a, dtype) for a in (x, sc, dy))

    def jloss(xx, ss):
        y = JL.norm({"scale": ss}, xx, jcfg)
        return jnp.sum(y.astype(jnp.float32) * jdy.astype(jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1))(jx, js)
    tx.requires_grad_(True)
    ts.requires_grad_(True)
    y = tops.rmsnorm(tx, ts)
    got = torch.autograd.grad(y, (tx, ts), tdy)
    for g, w, t in zip(got, want, (tx, ts)):
        assert g.dtype == t.dtype and g.shape == t.shape
        g, w = _np(g), _np(w)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        else:
            assert (np.abs(g - w) <= _bf16_step(w)).all()


def test_rmsnorm_bwd_ref_is_the_gradient_of_rmsnorm_ref():
    """The plain backward against autograd through the plain forward, in
    f64 (no rounding to compare)."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((7, 40))).requires_grad_(True)
    sc = torch.from_numpy(rng.standard_normal(40)).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((7, 40)))
    want = torch.autograd.grad(tops.ref.rmsnorm_ref(x, sc), (x, sc), dy)
    got = RN.rmsnorm_bwd(x.detach(), sc.detach(), dy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_functions_run_forward_only_under_inference_mode():
    """Prefill calls the same ops under inference_mode: no graph, the
    forward's values, and the backward wrappers never run."""
    q = torch.randn(1, 8, 2, 32)
    with torch.inference_mode():
        o = tops.attention(q, q, q, impl="pallas")
        y = tops.rmsnorm(q, torch.ones(32))
    assert o.grad_fn is None and y.grad_fn is None
    assert torch.equal(o, FA.flash_attention(q, q, q)[0])
    assert torch.equal(y, RN.rmsnorm(q, torch.ones(32)))


def test_backward_wrappers_reject_unknown_impl_and_devices():
    q = torch.zeros(1, 4, 2, 32)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError):
        FA.flash_attention_bwd(q, q, q, q, lse, q, impl="triton")
    with pytest.raises(ValueError):
        RN.rmsnorm_bwd(q, torch.ones(32), q, impl="triton")
    meta = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        RN.rmsnorm_bwd(meta, torch.ones(8, device="meta"), meta)
    with pytest.raises(ValueError, match="no kernel"):
        FA.flash_attention_bwd(*(t.to("meta") for t in (q, q, q, q, lse, q)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_naive_attention_matches_reference(dtype):
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((2, 32, 16), dtype=np.float32), dtype)
        for _ in range(3))
    np.testing.assert_allclose(
        _np(tops.ref.naive_attention(tq, tk, tv)),
        _np(jref.naive_attention(jq, jk, jv)),
        atol=ATOL[dtype], rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 64, 256), (3, 5, 96)])
def test_plain_rmsnorm_matches_reference(dtype, shape):
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal(shape, dtype=np.float32), dtype)
    js, ts = _pair(rng.standard_normal(shape[-1:], dtype=np.float32), dtype)
    want = jops.rmsnorm(jx, js, impl="pallas")
    got = tops.rmsnorm(tx, ts, impl="pallas")
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype],
                               rtol=RTOL[dtype])
    np.testing.assert_array_equal(_np(RN.rmsnorm(tx, ts, impl="plain")),
                                  _np(got))


def test_wrappers_reject_unknown_impl_and_devices():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        RN.rmsnorm(x, torch.ones(8), impl="triton")
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q, impl="triton")
    with pytest.raises(ValueError):
        tops.attention(q, q, q, impl="flash")
    # a tensor that is neither on the CPU nor on a CUDA card has no kernel:
    # the wrapper raises instead of running the plain version
    meta = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        RN.rmsnorm(meta, torch.ones(8, device="meta"))
    x, dt = torch.zeros(1, 16, 2, 8), torch.zeros(1, 16, 2)
    with pytest.raises(ValueError):
        SS.ssd_scan(x, dt, torch.zeros(2), x, x, impl="triton")
    with pytest.raises(ValueError, match="no kernel"):
        SS.ssd_scan(x.to("meta"), dt.to("meta"), torch.zeros(2, device="meta"),
                    x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="multiple of chunk"):
        SS.ssd_scan(x[:, :12], dt[:, :12], torch.zeros(2), x[:, :12],
                    x[:, :12], chunk=8)


@pytest.mark.parametrize("blk,size,want", [(512, 1024, 512), (512, 300, 300),
                                           (512, 1000, 8), (64, 96, 32)])
def test_fit_block_matches_reference(blk, size, want):
    assert tops._fit_block(blk, size) == jops._fit_block(blk, size) == want


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(norm_type, dtype):
    """models/layers.norm: RMSNorm through the kernel wrapper, LayerNorm in
    plain torch, both against the reference's jnp ``layers.norm``."""
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import layers as JL
    from repro_torch.configs.base import get_arch
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(5)
    jcfg = jax_get_arch("granite-3-8b").reduced().replace(norm_type=norm_type)
    tcfg = get_arch("granite-3-8b").reduced().replace(norm_type=norm_type)
    d = tcfg.d_model
    jx, tx = _pair(rng.standard_normal((2, 3, d), dtype=np.float32), dtype)
    p = {"scale": rng.standard_normal((d,), dtype=np.float32),
         "bias": rng.standard_normal((d,), dtype=np.float32)}
    jp = {k: _pair(v, dtype)[0] for k, v in p.items()}
    tp = {k: _pair(v, dtype)[1] for k, v in p.items()}
    got, want = TL.norm(tp, tx, tcfg), JL.norm(jp, jx, jcfg)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype],
                               rtol=RTOL[dtype])


# -- Mamba2 SSD chunk scan -----------------------------------------------------


def _ssd_inputs(seed, b, s, h, p, n, dtype, groups=None):
    """numpy-made SSD inputs (the reference test's distributions) as JAX
    arrays and torch tensors; xh/bb/cc in ``dtype``, dt/a in f32.  bb/cc
    have ``groups`` groups (default: one per head)."""
    rng = np.random.default_rng(seed)
    g = groups or h
    arrs = dict(
        xh=rng.standard_normal((b, s, h, p), dtype=np.float32),
        dt=np.log1p(np.exp(rng.standard_normal((b, s, h),
                                               dtype=np.float32))),
        a=-np.exp(rng.standard_normal((h,), dtype=np.float32)),
        bb=rng.standard_normal((b, s, g, n), dtype=np.float32),
        cc=rng.standard_normal((b, s, g, n), dtype=np.float32))
    low = ("xh", "bb", "cc")
    j = {k: _pair(v, dtype if k in low else "float32")[0]
         for k, v in arrs.items()}
    t = {k: _pair(v, dtype if k in low else "float32")[1]
         for k, v in arrs.items()}
    return j, t


SSD_SHAPES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32),
              (1, 256, 2, 64, 32, 64)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_plain_ssd_matches_reference_kernel_and_oracle(b, s, h, p, n, chunk):
    """The plain version against the reference's Pallas kernel (interpret
    mode) and its sequential oracle, at the reference test's shapes, f32."""
    j, t = _ssd_inputs(2, b, s, h, p, n, "float32")
    got, hT = tops.ssd_scan(t["xh"], t["dt"], t["a"], t["bb"], t["cc"],
                            chunk=chunk)
    assert hT is None and got.shape == t["xh"].shape
    pallas, _ = jops.ssd_scan(j["xh"], j["dt"], j["a"], j["bb"], j["cc"],
                              chunk=chunk)
    oracle = jref.ssd_ref(j["xh"], j["dt"], j["a"], j["bb"], j["cc"])
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-4,
                                   rtol=2e-4)
    np.testing.assert_allclose(
        _np(tops.ref.ssd_ref(t["xh"], t["dt"], t["a"], t["bb"], t["cc"])),
        _np(oracle), atol=2e-4, rtol=2e-4)


def test_plain_ssd_bf16_matches_oracle():
    """bf16 x/B/C (the reference test's bf16 case): y in bf16 within 0.05
    of the f32 sequential oracle."""
    j, t = _ssd_inputs(3, 1, 64, 2, 16, 8, "float32")
    oracle = jref.ssd_ref(j["xh"], j["dt"], j["a"], j["bb"], j["cc"])
    low = {k: (v.to(torch.bfloat16) if k in ("xh", "bb", "cc") else v)
           for k, v in t.items()}
    got, _ = SS.ssd_scan(low["xh"], low["dt"], low["a"], low["bb"],
                         low["cc"], chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(oracle), atol=0.05, rtol=0.05)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES[1:2])
def test_plain_ssd_state_matches_reference_ssd_chunked(b, s, h, p, n, chunk):
    """The final state hT (B, H, P, N) f32 -- which the TPU kernel does not
    return -- against the reference's jnp ``ssd_chunked``, whose serving
    handoff produces it."""
    from repro.models import ssm as JSSM
    j, t = _ssd_inputs(4, b, s, h, p, n, "float32")
    y, hT = SS.ssd_scan(t["xh"], t["dt"], t["a"], t["bb"], t["cc"],
                        chunk=chunk)
    want_y, want_h = JSSM.ssd_chunked(j["xh"], j["dt"], j["a"], j["bb"],
                                      j["cc"], chunk)
    assert hT.shape == (b, h, p, n) and hT.dtype == torch.float32
    np.testing.assert_allclose(_np(hT), _np(want_h), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(y), _np(want_y), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_groups_index_equals_reference_repeat(groups):
    """B/C given per group (G dividing H, as the model passes them) equal the
    reference's repeat over heads, y and hT; a chunk that no 64-row tile
    divides (48) and S < chunk both work."""
    b, h, p, n = 2, 4, 16, 8
    for s, chunk in ((96, 48), (32, 256)):
        _, t = _ssd_inputs(5, b, s, h, p, n, "float32", groups=groups)
        rep = {k: t[k].repeat_interleave(h // groups, dim=2)
               for k in ("bb", "cc")}
        y, hT = SS.ssd_scan(t["xh"], t["dt"], t["a"], t["bb"], t["cc"],
                            chunk=chunk)
        y_r, hT_r = SS.ssd_scan(t["xh"], t["dt"], t["a"], rep["bb"],
                                rep["cc"], chunk=chunk)
        assert torch.equal(y, y_r) and torch.equal(hT, hT_r)
        oracle = tops.ref.ssd_ref(t["xh"], t["dt"], t["a"], rep["bb"],
                                  rep["cc"])
        np.testing.assert_allclose(y.numpy(), oracle.numpy(), atol=2e-4,
                                   rtol=2e-4)


def test_ssd_kernel_shared_memory_fits_the_serving_chunk():
    """The bf16 kernel's shared memory at zamba2's chunk 256, P 64, N 64
    admits two blocks per SM, and chunk 512 (the top of the reference's
    ``SSD_CHUNKS``) fits one block's 227 KB; the f32 kernel, which stages
    the chunk in f32, still takes chunk 256 and not 512."""
    per_sm = SM_SHARED_BYTES // (SS.smem_bytes(256, 64, 64)
                                 + BLOCK_RESERVED_BYTES)
    assert per_sm >= 2
    assert SS.smem_bytes(512, 64, 64) <= SS.SMEM_LIMIT
    assert SS.smem_bytes(256, 64, 64, torch.float32) <= SS.SMEM_LIMIT
    assert SS.smem_bytes(512, 64, 64, torch.float32) > SS.SMEM_LIMIT


# The kernels' launch arithmetic, mirrored in the wrappers (pure Python) and
# read here from the CUDA sources, so that a mirror cannot drift from its
# kernel.  An H100 SM has 228 KB of shared memory, of which a block may take
# 227 KB and the runtime reserves 1 KB per resident block.
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
CSRC = _build.CSRC


def _cu_int(source, name):
    """The value of ``constexpr int <name> = <n>;`` in csrc/<source>."""
    found = re.findall(rf"constexpr int {name} = (\d+);",
                       (CSRC / source).read_text())
    assert len(found) == 1, (source, name, found)
    return int(found[0])


@pytest.mark.parametrize("name", ["BLOCK_M", "BLOCK_N", "Q_STAGES",
                                  "K_STAGES", "V_STAGES"])
def test_flash_wrapper_mirrors_the_kernels_tile_constants(name):
    assert getattr(FA, name) == _cu_int("flash_attention.cu", name)


def test_flash_wrapper_head_dims_are_the_kernels_instantiations():
    src = (CSRC / "flash_attention.cu").read_text()
    entry = src[src.index('extern "C" int mist_flash_attn_fwd'):]
    cases = tuple(int(c) for c in re.findall(r"case (\d+):", entry))
    assert cases == FA.HEAD_DIMS


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_flash_kernel_shared_memory_fits_every_head_dim(hd):
    assert FA.smem_bytes(hd) <= FA.SMEM_LIMIT


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_flash_head_dims_tile_the_tensor_core_steps(hd):
    """Every head dim is a whole number of k16 steps (S = Q K^T) and of
    8-column accumulator chunks (O), and a legal product width; the tiles
    are whole warpgroups of 64 rows and k16 steps of keys."""
    assert hd % 16 == 0 and 8 <= hd <= 256
    assert FA.BLOCK_N % 16 == 0 and FA.BLOCK_M % 64 == 0


def test_flash_ring_keeps_its_stated_residency_at_hd128():
    """K and V rings of at least two stages (V one more: its product with
    P trails the scores by a tile), Q double-buffered for the next work
    item, and at hd 128 shared memory still admits the design's resident
    blocks per SM."""
    assert FA.K_STAGES >= 2 and FA.V_STAGES == FA.K_STAGES + 1
    assert FA.Q_STAGES == 2
    per_sm = SM_SHARED_BYTES // (FA.smem_bytes(128) + BLOCK_RESERVED_BYTES)
    assert per_sm >= FA.RESIDENT_BLOCKS >= 1


@pytest.mark.parametrize("hd", [16, 48, 96, 100, 256])
def test_flash_wrapper_rejects_other_head_dims_before_launch(hd):
    with pytest.raises(ValueError, match="head_dim"):
        FA.smem_bytes(hd)
    q = torch.zeros(1, 4, 2, hd, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 1, hd, dtype=torch.bfloat16)
    # the launch path checks its inputs before it loads the library (the
    # no_kernel_build fixture fails the test if it does) or counts a launch
    with pytest.raises(ValueError, match="head_dim"):
        FA._launch(q, k, k, True, 1.0)


def test_rmsnorm_wrapper_mirrors_the_kernels_dispatch():
    """The widths the kernel holds in registers and its warps per block."""
    src = (CSRC / "rmsnorm.cu").read_text()
    widths = sorted(int(w) for w in re.findall(r"vec_ok && d == (\d+)", src))
    assert tuple(widths) == RN.RESIDENT_WIDTHS
    assert RN.WARPS_PER_BLOCK == _cu_int("rmsnorm.cu", "WARPS")


@pytest.mark.parametrize("d,esize,vec_ok,want", [
    (4096, 2, True, 16), (2560, 2, True, 10),     # bf16 serving widths
    (4096, 4, True, 32), (2560, 4, True, 20),     # f32
    (4096, 2, False, 0), (2560, 4, False, 0),     # rows not 16-byte aligned
    (8192, 2, True, 0), (2048, 2, True, 8), (1000, 2, True, 0),
    (1001, 4, False, 0), (2048, 4, True, 16)])
def test_rmsnorm_plan_holds_the_serving_widths_in_registers(d, esize, vec_ok,
                                                            want):
    """Register-resident instantiation for d 2048, 2560 and 4096, the generic
    kernel (0) otherwise; a resident row is whole 16-byte vectors per lane
    and at most 128 registers of it."""
    nv = RN.vectors_per_lane(d, esize, vec_ok)
    assert nv == want
    if nv:
        assert nv * 32 * (16 // esize) == d and nv * 4 <= 128


BWD_SRC = "flash_attention_bwd.cu"


@pytest.mark.parametrize("name", ["BLOCK_N", "BLOCK_M", "Q_STAGES",
                                  "DS_STAGES", "DQ_STAGES"])
def test_flash_bwd_wrapper_mirrors_the_kernels_tile_constants(name):
    assert getattr(FA, f"BWD_{name}") == _cu_int(BWD_SRC, name)


def test_flash_bwd_kernel_head_dims_and_shared_memory():
    """The backward kernel is instantiated for the forward's head dims, and
    its block's shared memory (``bwd_smem_bytes``, checked against the
    source's constants below) fits at each of them."""
    src = (CSRC / BWD_SRC).read_text()
    entry = src[src.index('extern "C" int mist_flash_attn_bwd'):]
    cases = tuple(int(c) for c in re.findall(r"case (\d+):", entry))
    assert cases == FA.HEAD_DIMS
    for hd in FA.HEAD_DIMS:
        assert FA.bwd_smem_bytes(hd) <= FA.SMEM_LIMIT


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_flash_bwd_shared_memory_fits_every_head_dim(hd):
    """K and V tiles, the q/dO ring, the dS^T tiles, the f32 dQ parts, the
    lse/delta rows, the mbarriers and the ticket, from the source's own
    constants, within the 232,448 bytes a block may take; every tile starts
    on the 1024 bytes its swizzle needs."""
    n, m = _cu_int(BWD_SRC, "BLOCK_N"), _cu_int(BWD_SRC, "BLOCK_M")
    qs, ds, dqs = (_cu_int(BWD_SRC, k) for k in ("Q_STAGES", "DS_STAGES",
                                                  "DQ_STAGES"))
    tiles = [n * hd * 2] * 2 + [m * hd * 2] * (2 * qs) + [n * m * 2] * ds \
        + [m * hd * 4] * dqs
    assert all(t % 1024 == 0 for t in tiles)
    n_bars = 1 + 2 * qs + 2 * dqs
    total = sum(tiles) + 2 * qs * m * 4 + 8 * n_bars + 8
    assert total == FA.bwd_smem_bytes(hd) <= FA.SMEM_LIMIT == 232448


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_flash_bwd_tiles_are_legal_wgmma_shapes(hd):
    """Every product is a wgmma of M 64 (a warpgroup's rows), N a multiple
    of 8 up to 256 and K whole steps of 16: S^T and dP^T (64 keys x BLOCK_M
    queries over hd), dV and dK (64 keys x hd over BLOCK_M queries), dQ (64
    queries x one head_dim panel of 64, 32 or 16 columns over BLOCK_N keys,
    one panel per consumer warpgroup); the dS^T rows of BLOCK_M bf16 are one
    128-byte swizzle row."""
    n, m = _cu_int(BWD_SRC, "BLOCK_N"), _cu_int(BWD_SRC, "BLOCK_M")
    warpgroups = _cu_int(BWD_SRC, "CONSUMERS") // 128
    assert n == 64 * warpgroups and m == 64
    panels = [64] * (hd // 64) + ([hd % 64] if hd % 64 else [])
    assert len(panels) <= warpgroups and sum(panels) == hd
    for mm, nn, kk in [(64, m, hd), (64, hd, m)] + \
            [(64, p, n) for p in panels]:
        assert mm == 64 and nn % 8 == 0 and 8 <= nn <= 256 and kk % 16 == 0
    assert m * 2 == 128


@pytest.mark.parametrize("b,sq,h,hd", [(1, 4096, 32, 128), (2, 330, 8, 128),
                                        (2, 129, 8, 32), (2, 1, 32, 80)])
def test_flash_bwd_scratch_matches_the_kernels_carve(b, sq, h, hd):
    """The wrapper's scratch (4-byte elements) is what ``carve`` in the
    source lays out: dq_accum (B, Sq, H, hd) f32, then lse2 and delta over
    Sq padded to whole query tiles, then the ticket and one counter per
    (batch, head, query tile); each piece the kernel copies in bulk starts
    on 16 bytes (64 MB of dq_accum at granite's training shape)."""
    src = (CSRC / BWD_SRC).read_text()
    carve = src[src.index("Scratch carve("):]
    carve = carve[:carve.index("\n}\n")]
    assert "B) * Sq * H * hd" in carve and "s.lse2 + rows" in carve
    assert "s.delta + rows" in carve and "1 + rows / BLOCK_M" in carve
    m = FA.BWD_BLOCK_M
    sqp = -(-sq // m) * m
    acc = b * sq * h * hd
    assert FA.bwd_scratch_elems(b, sq, h, hd) == \
        acc + 2 * b * h * sqp + 1 + b * h * sqp // m
    assert acc % 4 == 0 and (b * h * sqp) % 4 == 0 and sqp * 4 % 16 == 0
    if (b, sq, h, hd) == (1, 4096, 32, 128):
        assert acc * 4 == 64 * 2**20


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Both attention sources include csrc/hopper.cuh: an edit to it must
    give a new build directory, or a stale library would load."""
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    assert (tmp_path / "hopper.cuh").is_file()
    for name in ("flash_attention.cu", BWD_SRC):
        assert '#include "hopper.cuh"' in (tmp_path / name).read_text()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._build_dir()
    assert before == _build._build_dir()
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    assert _build._build_dir() != before
    assert all(p.suffix == ".cu" for p in _build._sources())


@pytest.mark.parametrize("rows,sms,blocks", [(1, 132, 1), (9, 132, 9),
                                             (4096, 132, 132), (4096, 4, 4),
                                             (300, 132, 132)])
def test_rmsnorm_bwd_grid_and_widths_mirror_the_kernel(rows, sms, blocks):
    """One block per SM and no more than there are rows (rows of the dscale
    scratch), each block a band of rows balanced to within one row; the
    launch constants are the kernel's, and rows up to the width whose
    generic column partials fit shared memory."""
    for name in ("BWD_ROWS", "BWD_COLS", "BWD_STAGE_ROWS", "BWD_RING_BYTES",
                 "BWD_MAX_STAGES"):
        assert getattr(RN, name) == _cu_int("rmsnorm.cu", name), name
    assert RN.bwd_blocks(rows, sms) == blocks
    bands = RN.bwd_bands(rows, blocks)
    assert bands[0][0] == 0 and bands[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    sizes = [hi - lo for lo, hi in bands]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    smem = re.findall(r"constexpr int BWD_SMEM_MAX = (\d+) - (\d+);",
                      (CSRC / "rmsnorm.cu").read_text())
    assert len(smem) == 1
    assert RN.BWD_MAX_WIDTH == (int(smem[0][0]) - int(smem[0][1])) // 4
    big = torch.zeros(2, RN.BWD_MAX_WIDTH + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most"):
        RN._launch_bwd(big, torch.ones(big.shape[-1], dtype=torch.bfloat16),
                       big, 1e-6)


def test_rmsnorm_bwd_wrapper_mirrors_the_kernels_dispatch():
    """The widths the backward streams through its ring are the source's
    instances, each with CW = d / (32 * BWD_COLS) consumer warps."""
    src = (CSRC / "rmsnorm.cu").read_text()
    entry = src[src.index("int launch_bwd(const void*"):]
    entry = entry[:entry.index("\n}\n")]
    widths = tuple(int(w) for w in re.findall(r"case (\d+):", entry))
    assert widths == RN.BWD_RING_WIDTHS
    for d in widths:
        assert f"launch_bwd_ring<T, S, {d} / (32 * BWD_COLS)>" in entry
        assert d % (32 * RN.BWD_COLS) == 0


@pytest.mark.parametrize("d,esize,vec_ok,want", [
    (4096, 2, True, 2), (2560, 2, True, 2),       # bf16 model widths
    (4096, 4, True, 4), (2560, 4, True, 4),       # f32
    (4096, 2, False, 0), (2560, 4, False, 0),     # rows not 16-byte aligned
    (8192, 2, True, 0), (2048, 2, True, 2), (1000, 2, True, 0),
    (1001, 4, False, 0), (57856, 2, True, 0), (2048, 4, True, 4)])
def test_rmsnorm_bwd_ring_route_takes_the_model_widths(d, esize, vec_ok,
                                                        want):
    """The ring route for d 2048, 2560 and 4096 with 16-byte aligned rows, in
    bf16 and f32 (BWD_COLS columns a consumer thread: 2 or 4 vectors), the
    generic route (0) otherwise.  A ring instance has at least two stages
    with at least 64 KB in flight beside the one being read, and fits a
    block's shared memory beside the widest generic route's."""
    nv = RN.bwd_vectors_per_thread(d, esize, vec_ok)
    assert nv == want
    if not nv:
        assert RN.bwd_block_warps(d, esize, vec_ok) == RN.WARPS_PER_BLOCK
        return
    assert nv * (16 // esize) == RN.BWD_COLS
    warps = RN.bwd_block_warps(d, esize, vec_ok)
    assert (warps - 1) * 32 * RN.BWD_COLS == d and warps <= 32
    stages = RN.bwd_ring_stages(d, esize)
    stage = 2 * RN.BWD_STAGE_ROWS * d * esize
    assert 2 <= stages <= RN.BWD_MAX_STAGES
    assert (stages - 1) * stage >= 64 * 1024
    assert stages * stage <= RN.BWD_MAX_WIDTH * 4


@pytest.mark.parametrize("rows,blocks", [(1, 1), (4, 1), (8, 1), (9, 2),
                                         (4096, 512)])
def test_rmsnorm_runs_one_warp_per_row(rows, blocks):
    """A decode step's few rows take one block; a prefill's 4096 rows want
    512 blocks of ``WARPS_PER_BLOCK`` warps (the kernel caps that at what
    the card holds and walks the rest in a grid-stride loop)."""
    assert RN.blocks_wanted(rows) == blocks


# -- the bf16 SSD kernel's plan, on the CPU -----------------------------------


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    """f32 -> (hi, lo), both bf16 values, hi + lo ~ t (the kernel's split2)."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _ssd_kernel_rounding(xh, dt, a, bb, cc, q, split_scores=True):
    """The bf16 kernel's arithmetic with its rounding points: scores
    ``G * exp(cum_t - cum_s) * dt_s`` rounded to bf16 hi + lo (or once),
    ``B * w`` and the entering state split into bf16 hi + lo, ``C h_in``
    formed before its rows are scaled by ``exp(cum_t)``; products exact and
    summed in f32, as the tensor cores do.  -> (y in xh's dtype, hT)."""
    bsz, s, h, p = xh.shape
    x = xh.float().permute(0, 2, 1, 3)
    dtf = dt.permute(0, 2, 1)
    bf = SS.repeat_groups(bb, h).float().permute(0, 2, 1, 3)
    cf = SS.repeat_groups(cc, h).float().permute(0, 2, 1, 3)
    da = dtf * a[None, :, None]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    state = torch.zeros((bsz, h, bf.shape[-1], p))
    ys = []
    for c0 in range(0, s, q):
        sl = slice(c0, c0 + q)
        xc, dtc, bc, ccc = x[:, :, sl], dtf[:, :, sl], bf[:, :, sl], \
            cf[:, :, sl]
        cum = torch.cumsum(da[:, :, sl], dim=-1)
        rel = cum[..., :, None] - cum[..., None, :]
        lmat = torch.exp(torch.where(tri, rel, torch.tensor(float("-inf"))))
        scores = (ccc @ bc.transpose(-1, -2)) * lmat * dtc[..., None, :]
        if split_scores:
            s_hi, s_lo = _split(scores)
            y = s_hi @ xc + s_lo @ xc
        else:
            y = _bf16(scores) @ xc
        h_hi, h_lo = _split(state)
        y = y + torch.exp(cum)[..., None] * (ccc @ h_hi + ccc @ h_lo)
        w = torch.exp(cum[..., -1:] - cum) * dtc
        bw_hi, bw_lo = _split(bc * w[..., None])
        local = bw_hi.transpose(-1, -2) @ xc + bw_lo.transpose(-1, -2) @ xc
        state = state * torch.exp(cum[..., -1])[..., None, None] + local
        ys.append(y)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(xh.dtype)
    return y, state.transpose(-1, -2)


def _serving_like_ssd_inputs(seed, b, s, h, p, n, g=1):
    """bf16 x/B/C and f32 dt/a drawn as chip_smoke.py draws them at the
    serving shape (x, B, C ~ N(0, 1); dt = softplus(N(0, 1));
    a = -exp(N(0, 1/4)))."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, dtype=np.float32))
    return (f(b, s, h, p).to(torch.bfloat16),
            torch.nn.functional.softplus(f(b, s, h)),
            -torch.exp(0.5 * f(h)),
            f(b, s, g, n).to(torch.bfloat16),
            f(b, s, g, n).to(torch.bfloat16))


def test_ssd_kernel_rounding_plan_holds_the_tolerances():
    """The bf16 kernel's rounding points, rehearsed at P = N = 64, chunk
    256, S 1024 (four chunks, so the state is handed on three times): y
    within the bf16 kernel tolerance of ``ssd_plain`` (f32 throughout), hT
    within 2e-4."""
    xh, dt, a, bb, cc = _serving_like_ssd_inputs(6, 1, 1024, 2, 64, 64)
    want_y, want_h = SS.ssd_plain(xh, dt, a, bb, cc, 256)
    got_y, got_h = _ssd_kernel_rounding(xh, dt, a, bb, cc, 256)
    np.testing.assert_allclose(_np(got_y), _np(want_y), atol=ATOL["bfloat16"],
                               rtol=RTOL["bfloat16"])
    np.testing.assert_allclose(got_h.numpy(), want_h.numpy(), atol=2e-4,
                               rtol=2e-4)


def test_ssd_scores_need_the_hi_lo_split():
    """Why the kernel splits the scores: rounded to bf16 once, y moves past
    the bf16 tolerance against the f32 plain version at the serving
    distributions; with the split it stays several times inside it."""
    xh, dt, a, bb, cc = _serving_like_ssd_inputs(7, 1, 512, 4, 64, 64)
    want, _ = SS.ssd_plain(xh, dt, a, bb, cc, 256)
    bound = ATOL["bfloat16"] + RTOL["bfloat16"] * want.float().abs()

    def worst(split):
        got, _ = _ssd_kernel_rounding(xh, dt, a, bb, cc, 256, split)
        return float(((got.float() - want.float()).abs() / bound).max())

    assert worst(False) > 1.0 > 2 * worst(True)


# -- the bf16 SSD backward kernel's plan, on the CPU ---------------------------

# chip_smoke.py's rule for the SSD backward kernel against ssd_bwd_plain:
# per tensor, max |got - want| <= tol * max |want| by the tensor's dtype
SSD_BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-4}
# the kernel's splits of f32 operands into bf16 hi + lo: W for dC, dH for
# dH x_s, H_in, C exp(cum); the scores, W for dB and dH in B_s dH are
# rounded once
SSD_BWD_SPLITS = ("w", "dh", "h_in", "c_exp")


def _product(a, b, split):
    """a @ b as the tensor cores form it: ``split`` names the f32 operand
    ("a" or "b") that is split into bf16 hi + lo (two exact products summed
    in f32) or "a1" / "b1" rounded once to bf16; the other is bf16 already."""
    if split in ("a1", "b1"):
        return (_bf16(a) @ b) if split == "a1" else (a @ _bf16(b))
    hi, lo = _split(a if split == "a" else b)
    return hi @ b + lo @ b if split == "a" else a @ hi + a @ lo


def _ssd_bwd_kernel_rounding(xh, dt, a, bb, cc, dy, q,
                             splits=SSD_BWD_SPLITS):
    """The bf16 backward kernel's arithmetic with its rounding points: G and
    dS exact, the scores rounded once to bf16 for dx, W = dS L dt split
    into hi + lo for dC and rounded once for dB, dH split for dH x_s
    (rounded once for B_s dH), H_in split for dy H_in^T (rows scaled by
    exp(cum_t) after), C exp(cum) split for dH_in's own part; a split left
    out of ``splits`` is rounded once.  Products exact and summed in f32.  dB and dC: each
    head's f32 part, summed over a cluster of ``bwd_cluster`` heads in rank
    order, then the group's cluster parts in order, rounded once.
    -> (dx, ddt, da, dbb, dcc) as ``ssd_bwd_plain`` returns them."""
    sp = {k: ("a" if k in splits else "a1") for k in SSD_BWD_SPLITS}
    bsz, s, h, p = xh.shape
    g, n = bb.shape[2], bb.shape[3]
    cl = SS.bwd_cluster(h, g)
    x = xh.float().permute(0, 2, 1, 3)
    dyf = dy.float().permute(0, 2, 1, 3)
    dtf = dt.permute(0, 2, 1)
    bf = SS.repeat_groups(bb, h).float().permute(0, 2, 1, 3)
    cf = SS.repeat_groups(cc, h).float().permute(0, 2, 1, 3)
    af = a[None, :, None]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    chunks = [slice(c0, c0 + q) for c0 in range(0, s, q)]
    state, entering = torch.zeros((bsz, h, n, p)), []
    for sl in chunks:
        entering.append(state)
        cum = torch.cumsum(dtf[:, :, sl] * af, -1)
        w = torch.exp(cum[..., -1:] - cum) * dtf[:, :, sl]
        state = state * torch.exp(cum[..., -1])[..., None, None] + \
            (bf[:, :, sl] * w[..., None]).transpose(-1, -2) @ x[:, :, sl]
    dx, dbf, dcf = torch.empty_like(x), torch.empty_like(bf), \
        torch.empty_like(cf)
    ddt, da = torch.empty_like(dtf), torch.zeros((bsz, h))
    dstate = torch.zeros((bsz, h, n, p))
    flip = {"a": "b", "a1": "b1"}
    for sl, h_in in zip(reversed(chunks), reversed(entering)):
        xc, dyc, dtc = x[:, :, sl], dyf[:, :, sl], dtf[:, :, sl]
        bc, ccc = bf[:, :, sl], cf[:, :, sl]
        cum = torch.cumsum(dtc * af, -1)
        lmat = torch.exp(torch.where(
            tri, cum[..., :, None] - cum[..., None, :],
            torch.tensor(float("-inf"))))
        gmat, dsm = ccc @ bc.transpose(-1, -2), dyc @ xc.transpose(-1, -2)
        smat = gmat * lmat * dtc[..., None, :]
        wmat = dsm * lmat * dtc[..., None, :]
        e_out, e_in = torch.exp(cum[..., -1:] - cum), torch.exp(cum)
        ed = (e_out * dtc)[..., None]
        own = _product((ccc * e_in[..., None]).transpose(-1, -2), dyc,
                       sp["c_exp"])
        car = e_in[..., None] * _product(dyc, h_in.transpose(-1, -2),
                                         flip[sp["h_in"]])
        xdh = _product(xc, dstate.transpose(-1, -2), flip[sp["dh"]])
        dx[:, :, sl] = _product(smat.transpose(-1, -2), dyc, "a1") + \
            ed * _product(bc, dstate, "b1")
        dbf[:, :, sl] = _product(wmat.transpose(-1, -2), ccc, "a1") + \
            ed * xdh
        dcf[:, :, sl] = _product(wmat, bc, sp["w"]) + car
        v = (bc * xdh).sum(-1)
        m = (dsm * smat).tril(-1)
        dcum = m.sum(-1) - m.sum(-2) + (ccc * car).sum(-1) - ed[..., 0] * v
        dcum[..., -1] += (ed[..., 0] * v).sum(-1) + \
            torch.exp(cum[..., -1]) * (h_in * dstate).sum((-1, -2))
        dda = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
        ddt[:, :, sl] = (dsm * gmat * lmat).sum(-2) + e_out * v + af * dda
        da += (dtc * dda).sum(-1)
        dstate = dstate * torch.exp(cum[..., -1])[..., None, None] + own

    def per_group(t):  # (B, H, S, N) -> (B, S, G, N), in the kernels' order
        heads = t.permute(0, 2, 1, 3).reshape(bsz, s, g, h // g // cl, cl, n)
        parts = heads[:, :, :, :, 0]
        for r in range(1, cl):
            parts = parts + heads[:, :, :, :, r]
        out = parts[:, :, :, 0]
        for k in range(1, parts.shape[3]):
            out = out + parts[:, :, :, k]
        return out

    return (dx.permute(0, 2, 1, 3).to(xh.dtype), ddt.permute(0, 2, 1),
            da.sum(0), per_group(dbf).to(bb.dtype),
            per_group(dcf).to(cc.dtype))


def _ssd_bwd_worst(got, want):
    """{name: max |got - want| / (SSD_BWD_TOL * max |want|)} per output."""
    return {name: float((u.float() - w.float()).abs().max())
            / (SSD_BWD_TOL[w.dtype] * float(w.float().abs().max()))
            for name, u, w in zip(("dx", "ddt", "da", "dB", "dC"), got, want)}


@pytest.fixture(scope="module")
def ssd_bwd_case():
    """P = N = 64, chunk 256, S 1024 (dH handed on three times), H 4, G 1,
    dy ~ N(0, 1) in bf16: the inputs and ``ssd_bwd_plain``'s gradient."""
    xh, dt, a, bb, cc = _serving_like_ssd_inputs(6, 1, 1024, 4, 64, 64)
    rng = np.random.default_rng(16)
    dy = torch.from_numpy(rng.standard_normal(xh.shape, dtype=np.float32)
                          ).to(torch.bfloat16)
    args = (xh, dt, a, bb, cc, dy, 256)
    return args, SS.ssd_bwd_plain(*args)


def test_ssd_bwd_kernel_rounding_plan_holds_the_tolerances(ssd_bwd_case):
    """The bf16 backward kernel's rounding points and its cluster-then-group
    dB / dC sums, rehearsed against ``ssd_bwd_plain`` (f32 throughout):
    every output within SSD_BWD_TOL of its largest value (dx and dB, whose
    scores and W are rounded once, at ~0.6 of it; the rest at a quarter or
    less)."""
    args, want = ssd_bwd_case
    worst = _ssd_bwd_worst(_ssd_bwd_kernel_rounding(*args), want)
    assert max(worst["dx"], worst["dB"]) < 1.0, worst
    assert max(v for k, v in worst.items() if k not in ("dx", "dB")) < 0.25, \
        worst


@pytest.mark.parametrize("split,outputs", [
    ("dh", ("ddt",)), ("h_in", ("ddt",)), ("c_exp", ("ddt",)),
    ("w", ("dC",))])
def test_ssd_bwd_kernel_needs_each_split(ssd_bwd_case, split, outputs):
    """Why the kernel splits each f32 operand it splits.  Rounded once, dH
    (in dH x_s, which feeds u), H_in (y_inter) or C exp(cum) (dH_in, carried
    to every earlier chunk) puts ddt past its 2e-4; W rounded once for dC
    keeps dC inside its 1e-2, but at over half of it and 3x the split's
    error (0.7 of it at 80 heads)."""
    args, want = ssd_bwd_case
    kept = _ssd_bwd_worst(_ssd_bwd_kernel_rounding(*args), want)
    dropped = _ssd_bwd_worst(_ssd_bwd_kernel_rounding(
        *args, splits=tuple(x for x in SSD_BWD_SPLITS if x != split)), want)
    for name in outputs:
        if split == "w":
            assert 1.0 > dropped[name] > max(0.5, 3 * kept[name]), \
                (name, dropped, kept)
        else:
            assert dropped[name] > 1.0 > 10 * kept[name], (name, dropped,
                                                            kept)


# -- the flash backward kernel's plan, on the CPU ------------------------------

LOG2E = 1.4426950408889634
# chip_smoke.py's relative rule for the flash backward (FLASH_BWD_REL,
# FLASH_BWD_TILE): ||got - want|| / ||want|| in every (batch, 128-row tile,
# head), and max |got - want| / max |want|
FLASH_BWD_REL, FLASH_BWD_TILE = 1e-2, 128


def _flash_bwd_kernel_rounding(q, k, v, o, lse, dout, causal, scale):
    """The backward kernel's arithmetic in its order, q/o/dout
    (B, Sq, H, hd) and k/v (B, Sk, KV, hd) bf16, lse (B, H, Sq) f32: per key
    tile of BWD_BLOCK_N, S^T and dP^T summed in f32, P = exp2(S c - lse
    log2(e)) with c = scale log2(e) (0 where masked), P and dS rounded to
    bf16 as product operands, dK and dV summed in f32 over the query tiles
    and the group's heads, dQ's per-key-tile parts added in f32 in
    ascending key-tile order; each output rounded once.  -> dq, dk, dv."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    heads = lambda x: x.float().permute(0, 2, 1, 3)  # noqa: E731
    qf, of, dof = heads(q), heads(o), heads(dout)   # (B, H, Sq, hd)
    kf = heads(k).repeat_interleave(g, 1)           # (B, H, Sk, hd)
    vf = heads(v).repeat_interleave(g, 1)
    delta = (dof * of).sum(-1, keepdim=True)
    lse2 = lse[..., None] * LOG2E
    c = scale * LOG2E
    qpos = torch.arange(sq)[:, None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for n0 in range(0, sk, FA.BWD_BLOCK_N):
        kt, vt = kf[:, :, n0:n0 + FA.BWD_BLOCK_N], vf[:, :, n0:n0 + FA.BWD_BLOCK_N]
        kpos = n0 + torch.arange(kt.shape[2])[None, :]
        p = torch.exp2(qf @ kt.transpose(-1, -2) * c - lse2)
        if causal:
            p = torch.where(qpos >= kpos, p, torch.zeros(()))
        dvs.append(_bf16(p).transpose(-1, -2) @ dof)
        dp = dof @ vt.transpose(-1, -2)
        ds = _bf16(p * (dp - delta) * scale)
        dks.append(ds.transpose(-1, -2) @ qf)
        dq = dq + ds @ kt

    def out(x, heads_):  # (B, H, S, hd) f32 -> (B, S, heads_, hd) bf16
        x = x.reshape(b, heads_, h // heads_, x.shape[2], hd).sum(2)
        return x.permute(0, 2, 1, 3).to(torch.bfloat16)

    return out(dq, h), out(torch.cat(dks, 2), kv), out(torch.cat(dvs, 2), kv)


def _tile_rel(got, want, tile=FLASH_BWD_TILE):
    """chip_smoke.tile_rel_err: the worst relative error over (batch, tile
    of rows, head) blocks of a (B, S, heads, hd) gradient, and max err /
    max |want|."""
    got, want = got.float(), want.float()
    b, s, h, _ = want.shape
    pad = (-s) % tile

    def block_sq(x):
        x = torch.nn.functional.pad(x.square().sum(-1), (0, 0, 0, pad))
        return x.view(b, (s + pad) // tile, tile, h).sum(2)

    rel = (block_sq(got - want) / block_sq(want).clamp_min(1e-30)).sqrt()
    return float(rel.max()), float((got - want).abs().max()
                                   / want.abs().max())


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", [
    (1, 320, 320, 4, 2, 64, True),     # GQA, 3 key tiles, 5 query tiles
    (2, 150, 200, 2, 1, 32, False),    # ragged query and key tiles
], ids=["causal-gqa", "full-ragged"])
def test_flash_bwd_kernel_rounding_plan_holds_the_tolerances(
        b, sq, sk, h, kv, hd, causal):
    """The kernel's rounding points and summation order, rehearsed on the
    CPU against the reference's _blocked_bwd run in f32 on the same bf16
    values (dk/dv of the broadcast heads summed over each group): the
    reference's bf16 tolerance per element (5e-2) and chip_smoke.py's
    relative rule (1e-2) on dq, dk and dv."""
    rng = np.random.default_rng(16)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(torch.bfloat16) for shape in
        ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd), (b, sq, h, hd)))
    g, scale = h // kv, hd ** -0.5
    flat = lambda x, rep: jnp.asarray(  # noqa: E731  (B*H, S, hd) f32
        x.float().repeat_interleave(rep, 2).permute(0, 2, 1, 3)
        .reshape(b * h, x.shape[1], hd).numpy())
    jq, jk, jv, jdo = flat(q, 1), flat(k, g), flat(v, g), flat(dout, 1)
    block = tops._fit_block(64, sk)
    jo, jlse = jops._blocked_fwd(jq, jk, jv, causal, scale, block)
    want = jops._blocked_bwd(jq, jk, jv, jo, jlse, jdo, causal, scale, block)
    o = torch.from_numpy(np.array(jo)).reshape(b, h, sq, hd) \
        .permute(0, 2, 1, 3).to(torch.bfloat16)
    lse = torch.from_numpy(np.array(jlse)).reshape(b, h, sq)
    got = _flash_bwd_kernel_rounding(q, k, v, o, lse, dout, causal, scale)
    for name, gt, w, heads_ in zip("qkv", got, want, (h, kv, kv)):
        w = torch.from_numpy(np.array(w)).reshape(b, heads_, h // heads_,
                                                  -1, hd).sum(2) \
            .permute(0, 2, 1, 3)
        assert gt.shape == w.shape, name
        np.testing.assert_allclose(_np(gt), w.numpy(),
                                   atol=BWD_TOL["bfloat16"],
                                   rtol=BWD_TOL["bfloat16"])
        tile, top = _tile_rel(gt, w)
        assert tile <= FLASH_BWD_REL and top <= FLASH_BWD_REL, \
            (name, tile, top)


# -- the RMSNorm backward kernel's summation order, on the CPU -----------------


def _rmsnorm_bwd_kernel_order(x, scale, dy, sms, eps=1e-6):
    """The backward kernel's arithmetic in its order, x/dy (rows, d):
    each block of the grid walks its band of rows in order, forms dx in f32
    and adds g * (x r) into its f32 column partials row after row; the
    blocks' partials are then added in the kernel's fixed order (per warp
    a run of blocks in ascending order, then the warps' sums in ascending
    order).  Each output is rounded once.  -> dx, dscale."""
    rows, d = x.shape
    xf, gf, sf = x.float(), dy.float(), scale.float()
    blocks = RN.bwd_blocks(rows, sms)
    dx = torch.empty_like(xf)
    part = []
    for lo, hi in RN.bwd_bands(rows, blocks):
        p = torch.zeros(d)
        for row in range(lo, hi):
            r = torch.rsqrt((xf[row] * xf[row]).sum() / d + eps)
            c = r * r * r * ((gf[row] * sf * xf[row]).sum() / d)
            dx[row] = r * gf[row] * sf - xf[row] * c
            p = p + gf[row] * (xf[row] * r)
        part.append(p)
    warps = RN.bwd_block_warps(d, x.element_size(), True)
    dscale = torch.zeros(d)
    for run in RN.bwd_dscale_order(blocks, warps):
        acc = torch.zeros(d)
        for b in run:
            acc = acc + part[b]
        dscale = dscale + acc
    return dx.to(x.dtype), dscale.to(scale.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d,sms", [(40, 2560, 6), (21, 96, 6),
                                        (9, 4096, 16)],
                         ids=["ring", "generic", "ring-rows-under-sms"])
def test_rmsnorm_bwd_kernel_summation_order_holds_the_tolerances(
        dtype, rows, d, sms):
    """The kernel's per-block dscale partials, combined in its fixed order,
    against jax.grad of the reference's layers.norm at the tolerances of
    test_rmsnorm_function_grads_match_reference: f32 within 1e-5, bf16
    within one bf16 step."""
    import jax
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import layers as JL
    jcfg = jax_get_arch("granite-3-8b").reduced().replace(d_model=d)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((rows, d), dtype=np.float32)
    sc = 1 + 0.1 * rng.standard_normal(d, dtype=np.float32)
    dy = rng.standard_normal((rows, d), dtype=np.float32)
    (jx, tx), (js, ts), (jdy, tdy) = (_pair(a, dtype) for a in (x, sc, dy))

    def jloss(xx, ss):
        y = JL.norm({"scale": ss}, xx, jcfg)
        return jnp.sum(y.astype(jnp.float32) * jdy.astype(jnp.float32))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jx, js)
    got = _rmsnorm_bwd_kernel_order(tx, ts, tdy, sms)
    assert len(RN.bwd_dscale_order(RN.bwd_blocks(rows, sms),
                                   RN.bwd_block_warps(d, 4, True))) > 1
    for g, w, t in zip(got, want, (tx, ts)):
        assert g.dtype == t.dtype and g.shape == t.shape
        g, w = _np(g), _np(w)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        else:
            assert (np.abs(g - w) <= _bf16_step(w)).all()


def test_rmsnorm_bwd_dscale_order_covers_every_block_once():
    """Every block's partial is added exactly once, in ascending order, in
    runs of ceil(blocks / warps) blocks (the last may be shorter), at most
    one run a warp of the block."""
    for blocks in (1, 5, 9, 10, 132):
        for warps in (6, 8, 9):
            runs = RN.bwd_dscale_order(blocks, warps)
            per = -(-blocks // warps)
            assert 1 <= len(runs) <= warps
            assert [b for run in runs for b in run] == list(range(blocks))
            assert all(len(run) == per for run in runs[:-1])
            assert 1 <= len(runs[-1]) <= per


@pytest.mark.parametrize("name", ["TC_WARPS", "ROW_BLOCK", "SMEM_PAD"])
def test_ssd_wrapper_mirrors_the_kernels_tile_constants(name):
    assert getattr(SS, name) == _cu_int("ssd_scan.cu", name)


def test_ssd_wrapper_mirrors_the_kernels_sizes():
    """Threads, the P / N menu (multiples of one k16 step up to MAX_DIM),
    shared memory at the serving chunk (x and B padded, the entering state
    as hi + lo, cum / dt / w, the scan's warp sums and the ticket) and the
    chain's f32 scratch at zamba2's prefill (15.7 MB)."""
    assert _cu_int("ssd_scan.cu", "TC_THREADS") == 32 * SS.TC_WARPS
    assert SS.TC_DIMS == tuple(range(16, _cu_int("ssd_scan.cu", "MAX_DIM")
                                     + 1, 16))
    src = (CSRC / "ssd_scan.cu").read_text()
    for entry in ("int launch_tc_p(", "int launch_tc("):  # N, then P
        body = src[src.index(entry):]
        body = body[:body.index("\n}\n")]
        cases = tuple(int(c) for c in re.findall(r"case (\d+):", body))
        assert cases == SS.TC_DIMS, (entry, cases)
    assert SS.MAX_HEAD_DIM == _cu_int("ssd_scan.cu", "MAX_DIM")
    assert SS.SMEM_LIMIT == _cu_int("ssd_scan.cu", "MAX_SMEM")
    assert SS.smem_bytes(256, 64, 64) == 2 * (256 * 72 * 2 + 2 * 64 * 72) \
        + 4 * (3 * 256 + 8 + 4) == 95280
    assert SS.smem_bytes(40, 32, 16) == SS.smem_bytes(48, 32, 16)  # padded
    assert SS.state_scratch_shape(4, 80, 4, 64, 64) == (3, 4, 80, 64, 64)
    assert 4 * np.prod(SS.state_scratch_shape(4, 80, 4, 64, 64)) \
        == 15_728_640
    assert SS.sync_words(4, 80, 4) == 1 + 4 * 80 * 3
    assert SS.sync_words(2, 8, 1) == 1  # one chunk: no state is handed on


@pytest.mark.parametrize("case", ["p8", "n80", "p40", "chunk1024",
                                  "x_offset", "b_stride", "f16"])
def test_ssd_wrapper_rejects_what_the_bf16_kernel_does_not_take(case):
    """Outside the bf16 kernel's limits the launch path raises before it
    loads the library (the no_kernel_build fixture) or counts a launch."""
    q = 64
    shape = dict(p8=dict(p=8), n80=dict(n=80), p40=dict(p=40),
                 chunk1024=dict(s=1024)).get(case, {})
    shape = {**dict(s=64, p=64, n=64), **shape}
    x, dt, a, bb, cc = _serving_like_ssd_inputs(8, 1, shape["s"], 2,
                                                shape["p"], shape["n"])
    if case == "chunk1024":
        q = 1024
    elif case == "x_offset":   # x one element into its buffer
        buf = torch.zeros(x.numel() + 1, dtype=x.dtype)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(x.shape)
    elif case == "b_stride":   # B rows of 68 elements: 136 bytes
        wide = torch.zeros(bb.shape[:3] + (68,), dtype=bb.dtype)
        wide[..., :64] = bb
        bb = wide[..., :64]
    elif case == "f16":
        x, bb, cc = x.half(), bb.half(), cc.half()
    args = (x, dt, a, bb, cc)
    err = TypeError if case == "f16" else ValueError
    with pytest.raises(err):
        SS._launch(*args, q)


def test_ssd_bf16_kernel_takes_ragged_chunks_and_chunk_512():
    """No check of the launch path refuses a chunk that no 16-row tile
    divides (40: padded rows) or chunk 512 at P = N = 64; they stop only at
    the library (which the no_kernel_build fixture refuses)."""
    for s, q in ((40, 40), (1024, 512), (288, 96)):
        x, dt, a, bb, cc = _serving_like_ssd_inputs(8, 1, s, 2, 64, 64)
        SS._check_cuda_inputs(x, dt, a, bb, cc)
        SS._check_tc_route(x, bb, cc, q)
        with pytest.raises(AssertionError, match="kernel loader"):
            SS._launch(x, dt, a, bb, cc, q)
