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
    yield
    assert FA.LAUNCHES == 0 and RN.LAUNCHES == 0 and SS.LAUNCHES == 0


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
    """The kernel's shared memory at zamba2's chunk 256, P 64, N 64 fits a
    block's 227 KB; chunk 512 does not, and the wrapper says so before any
    launch."""
    assert SS.smem_bytes(256, 64, 64) <= SS.SMEM_LIMIT
    assert SS.smem_bytes(512, 64, 64) > SS.SMEM_LIMIT


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
    (8192, 2, True, 0), (2048, 2, True, 0), (1000, 2, True, 0),
    (1001, 4, False, 0)])
def test_rmsnorm_plan_holds_the_serving_widths_in_registers(d, esize, vec_ok,
                                                            want):
    """Register-resident instantiation for d 2560 and 4096, the generic
    kernel (0) otherwise; a resident row is whole 16-byte vectors per lane
    and at most 128 registers of it."""
    nv = RN.vectors_per_lane(d, esize, vec_ok)
    assert nv == want
    if nv:
        assert nv * 32 * (16 // esize) == d and nv * 4 <= 128


@pytest.mark.parametrize("rows,blocks", [(1, 1), (4, 1), (8, 1), (9, 2),
                                         (4096, 512)])
def test_rmsnorm_runs_one_warp_per_row(rows, blocks):
    """A decode step's few rows take one block; a prefill's 4096 rows want
    512 blocks of ``WARPS_PER_BLOCK`` warps (the kernel caps that at what
    the card holds and walks the rest in a grid-stride loop)."""
    assert RN.blocks_wanted(rows) == blocks
