"""The port's kernel modules against the JAX reference, on the CPU.

On a CPU tensor each wrapper runs its plain version (the Hopper kernels
run only on the card, where chip_smoke.py holds them against these same
plain versions).  Inputs are made with numpy from a seed and given to both
packages.  Tolerances are the reference's own (tests/test_kernels.py):
2e-5 in f32, 2e-2 / 3e-2 in bf16.
"""
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
    FA.LAUNCHES = RN.LAUNCHES = 0
    yield
    assert FA.LAUNCHES == 0 and RN.LAUNCHES == 0


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
