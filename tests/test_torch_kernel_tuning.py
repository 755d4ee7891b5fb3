"""The kernel-config plan dimension in the port (the cases of
``tests/test_kernel_tuning.py`` on ``repro_torch``, with the Hopper tile
menu of ``repro_torch.kernels.tiles``): byte-identity at the frozen
default, bitwise symbolic/concrete kernel terms, the legal grid's
invariants, the tuned path end to end; the plain versions at every menu
tile against the reference's routes at the same tile; and the wrappers'
refusal of a tuple outside the menu before any launch.

Everything runs on the CPU: ``verify_config`` and ``bench_config`` take
the plain versions there (the kernels run on the card, in
``chip_smoke.py``'s phase K)."""
import dataclasses
import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hardware import V5E
from repro.kernels import ops as jops
from repro_torch.configs.base import get_arch
from repro_torch.core import golden
from repro_torch.core import symbolic as S
from repro_torch.core.costmodel_params import (KERNEL_CONCRETE_OPS,
                                               KERNEL_SYMBOLIC_OPS,
                                               KernelCoeffs,
                                               kernel_smem_terms,
                                               kernel_time_terms,
                                               ssd_dims)
from repro_torch.core.hardware import H100, HardwareSpec
from repro_torch.core.plan import DEFAULT_KERNEL_CONFIG, KernelConfig, Plan
from repro_torch.core.schedule import DEFAULT_KERNEL_GRID
from repro_torch.core.tuner import MistTuner, TuneSpec
from repro_torch.kernels import _build, autotune, tiles
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd_scan as SS

# the reference's hardware, as a port spec (the golden fixtures' spec)
V5E_VALUES = HardwareSpec(**dataclasses.asdict(V5E))

# every tuple a plan may carry into the kernels at zamba2's dims and seq
# 4096: in each field the default or a Hopper menu entry, the entries that
# run the default's tile included
MENU_TUPLES = list(itertools.product(*(
    dict.fromkeys((DEFAULT_KERNEL_CONFIG.astuple()[i],) + menu)
    for i, menu in enumerate((
        tiles.MENU["attn_q_block"], tiles.kv_block_menu(80),
        tiles.MENU["rmsnorm_block"], tiles.ssd_chunk_menu(64, 64))))))


def _spec(arch, **kw):
    return TuneSpec(arch=arch, seq_len=2048, global_batch=16, n_devices=8,
                    stage_counts=(1,), grad_accums=(2,), **kw)


# -- frozen-default byte-identity --------------------------------------------


def test_frozen_default_matches_golden_fixture():
    """With the kernel dimension frozen to the default tuple (the default
    TuneSpec), a golden cell reproduces its committed fixture."""
    space, arch = "megatron", "granite-3-8b"
    want = json.loads(golden.golden_path(space, arch).read_text())
    doc = golden.compute_doc(space, arch, hw=V5E_VALUES)
    assert golden.diff_docs(want["doc"], doc) == []
    assert golden.fingerprint(doc) == want["fingerprint"]


def test_explicit_default_grid_is_identical():
    arch = get_arch("granite-3-8b").reduced()
    r0 = MistTuner(_spec(arch)).tune()
    r1 = MistTuner(_spec(arch, kernel_grid=DEFAULT_KERNEL_GRID)).tune()
    assert r0.objective == r1.objective
    assert r0.plan.to_json() == r1.plan.to_json()


def test_default_kernel_omitted_from_plan_json():
    arch = get_arch("granite-3-8b").reduced()
    rep = MistTuner(_spec(arch)).tune()
    assert rep.plan.kernel == DEFAULT_KERNEL_CONFIG
    assert '"kernel"' not in rep.plan.to_json()
    assert Plan.from_json(rep.plan.to_json()) == rep.plan


def test_nondefault_kernel_roundtrips():
    arch = get_arch("granite-3-8b").reduced()
    rep = MistTuner(_spec(arch)).tune()
    tuned = rep.plan.replace(kernel=KernelConfig(512, 64, 8, 128))
    assert '"kernel"' in tuned.to_json()
    assert Plan.from_json(tuned.to_json()) == tuned


# -- symbolic == concrete kernel terms, bitwise ------------------------------


def _env(config):
    return dict(zip(("qb", "kvb", "rnb", "sch"),
                    (float(v) for v in config)))


def _syms():
    return dict(qb=S.Sym("qb"), kvb=S.Sym("kvb"), rnb=S.Sym("rnb"),
                sch=S.Sym("sch"))


@pytest.mark.parametrize("config", MENU_TUPLES, ids=str)
def test_time_terms_symbolic_matches_concrete(config):
    """The one formula over Exprs (the tapes) and over floats (the bench
    predictor) agrees bitwise at every tuple of the menu and the
    default."""
    kw = dict(seq=2048, b=4.0, tp=2.0, sp_div=2.0, num_heads=32,
              head_dim=128, d_model=4096, ssd_heads=64, ssd_head_dim=64,
              ssd_state=64, hbm_bw=H100.hbm_bw,
              peak_flops=H100.peak_flops_bf16, kc=KernelCoeffs())
    env = _env(config)
    sym = kernel_time_terms(ops=KERNEL_SYMBOLIC_OPS, **_syms(), **kw)
    con = kernel_time_terms(ops=KERNEL_CONCRETE_OPS, **env, **kw)
    for op in ("attn", "rms", "ssd"):
        got = float(S.wrap(sym[op]).evaluate(env, {}))
        assert got == con[op], (op, got, con[op])


@pytest.mark.parametrize("config", MENU_TUPLES, ids=str)
def test_smem_terms_symbolic_matches_concrete(config):
    kw = dict(head_dim=80, d_model=2560, ssd_head_dim=64, ssd_state=64)
    env = _env(config)
    sym = kernel_smem_terms(ops=KERNEL_SYMBOLIC_OPS, **_syms(), **kw)
    con = kernel_smem_terms(ops=KERNEL_CONCRETE_OPS, **env, **kw)
    for op in ("attn", "rms", "ssd"):
        got = float(S.wrap(sym[op]).evaluate(env, {}))
        assert got == con[op], (op, got, con[op])
    # the kernels' own formulas at the tiles the tuple runs
    _qr, kn, _rw, sch = tiles.hopper_tiles(config)
    assert con["attn"] == max(FA.smem_bytes(80, kn), FA.bwd_smem_bytes(80, kn))
    assert con["ssd"] == max(SS.smem_bytes(sch, 64, 64),
                             SS.bwd_smem_bytes(sch, 64, 64))


def test_delta_term_is_exactly_zero_at_default():
    """The cost model prices kernels as roofline(config) -
    roofline(default); at the default binding the delta is exactly 0.0."""
    from repro_torch.core.costmodel import StageCostModel
    for name in ("granite-3-8b", "zamba2-2.7b"):
        arch = get_arch(name).reduced()
        scm = StageCostModel(arch, 2048)
        env = _env(DEFAULT_KERNEL_CONFIG.astuple())
        env.update(b=2.0, dp=2.0, tp=2.0, zero=1.0,
                   ckpt=float(arch.num_layers), wo=0.0, go=0.0, oo=0.0,
                   ao=0.0, L=float(arch.num_layers), inflight=1.0, G=2.0)
        val = scm.kernel_time_delta.evaluate(scm._env(env), {})
        assert float(np.asarray(val)) == 0.0
        # and not zero off it: the menu moves the price
        env.update(_env((512, 64, 8, 128)))
        assert float(np.asarray(
            scm.kernel_time_delta.evaluate(scm._env(env), {}))) != 0.0


# -- the legal grid ----------------------------------------------------------


@pytest.mark.parametrize("name,seq", [("granite-3-8b", 4096),
                                      ("zamba2-2.7b", 4096),
                                      ("zamba2-2.7b", 192)])
def test_legal_grid_invariants(name, seq):
    """Default first, deterministic, capped, unique; every entry runs on
    the kernels (its Hopper tiles are menu entries), fits a block's shared
    memory forward AND backward, and each non-default tile divides the
    sequence."""
    arch = get_arch(name)
    grid = autotune.legal_kernel_grid(arch, seq_len=seq, max_tuples=8)
    assert grid == autotune.legal_kernel_grid(arch, seq_len=seq,
                                              max_tuples=8)
    assert grid[0] == DEFAULT_KERNEL_CONFIG.astuple()
    assert len(grid) <= 8 and len(set(grid)) == len(grid)
    assert len({tiles.hopper_tiles(t) for t in grid}) == len(grid)
    hd = arch.head_dim
    _h, p, n = ssd_dims(arch)
    sdef = autotune.predict_smem(arch)
    for tup in grid:
        for v in tup:
            assert v >= 8 and (v & (v - 1)) == 0, grid
        qr, kn, rw, sch = tiles.hopper_tiles(tup)
        assert kn in tiles.kv_block_menu(hd) and rw in tiles.MENU[
            "rmsnorm_block"]
        assert max(FA.smem_bytes(hd, kn), FA.bwd_smem_bytes(hd, kn)) \
            <= FA.SMEM_LIMIT
        for f, v in zip(tiles.FIELDS, tup):
            if v != tiles.REF_DEFAULT[f]:
                assert seq % v == 0, (f, tup)
        if arch.family == "hybrid":
            assert sch in tiles.ssd_chunk_menu(p, n)
            assert sch <= SS.BWD_MAX_CHUNK
            assert SS.smem_bytes(sch, p, n) <= SS.SMEM_LIMIT
            assert SS.bwd_smem_bytes(sch, p, n) <= SS.SMEM_LIMIT
        sm = autotune.predict_smem(arch, KernelConfig(*tup))
        for op in sm:
            assert sm[op] <= max(H100.vmem_bytes, sdef[op])
    if name == "zamba2-2.7b" and seq == 4096:
        # P = N = 64: chunks 64 and 128 beside the default 256; 512, which
        # the forward alone takes, stays out
        assert tiles.ssd_chunk_menu(64, 64) == (64, 128, 256)
        assert {t[3] for t in grid} <= {64, 128, 256}
    if seq == 192:
        assert {t[3] for t in grid} == {256, 64}


def test_plan_validation_rejects_bad_kernel_blocks():
    from repro_torch.core.schedule import validate_plan
    arch = get_arch("granite-3-8b").reduced()
    plan = MistTuner(_spec(arch)).tune().plan
    bad = plan.replace(kernel=KernelConfig(attn_q_block=96))
    assert any("attn_q_block" in p for p in validate_plan(bad, arch, 8, 16))
    assert not any("kernel" in p or "block" in p
                   for p in validate_plan(plan, arch, 8, 16))


# -- the tuned path end to end -----------------------------------------------


@pytest.mark.parametrize("name", ["granite-3-8b", "zamba2-2.7b"])
def test_kernel_sweep_improves_and_verifies(name):
    """The kernel dimension can only improve the objective (the default
    rides in the grid), the grid is the Hopper menu's, and the selection
    runs through every kernel the arch uses (here, on the CPU, their plain
    versions)."""
    arch = get_arch(name).reduced()
    base = MistTuner(_spec(arch)).tune()
    tuner = MistTuner(_spec(arch, kernel_tune=True))
    assert tuner.kernel_grid() == autotune.legal_kernel_grid(
        arch, seq_len=2048, hw=H100)
    tuned = tuner.tune()
    assert tuned.objective <= base.objective
    tiles.hopper_tiles(tuned.plan.kernel)
    assert autotune.verify_config(arch, seq_len=512,
                                  config=tuned.plan.kernel, device="cpu")


def test_kernel_sweep_worker_identity():
    """The kernel grid rides inside TuneSpec: forked sweep workers
    recompute the identical grid and select the same plan."""
    arch = get_arch("granite-3-8b").reduced()
    grid = autotune.legal_kernel_grid(arch, seq_len=2048)[:2]
    r1 = MistTuner(_spec(arch, kernel_grid=grid)).tune()
    r2 = MistTuner(_spec(arch, kernel_grid=grid, workers=2)).tune()
    assert r1.objective == r2.objective
    assert r1.plan.to_json() == r2.plan.to_json()


def test_tuned_plan_lowers_with_kernel_exec_config():
    """plan.kernel threads through lower_plan into every stage's
    ExecConfig (and the serve config)."""
    from repro_torch.lowering import lower_plan, plan_mesh
    arch = get_arch("granite-3-8b").reduced()
    plan = MistTuner(_spec(arch)).tune().plan.replace(
        kernel=KernelConfig(512, 64, 8, 128), attn_impl="pallas",
        use_pallas=True)
    low = lower_plan(arch, None, plan, plan_mesh(plan))
    ec = low.stages[0].exec_cfg
    assert (ec.attn_q_block, ec.attn_kv_block, ec.rmsnorm_block,
            ec.ssd_chunk) == (512, 64, 8, 128)
    assert low.serve_exec_cfg.attn_kv_block == 64
    assert low.plan_exec_cfg.rmsnorm_block == 8


def test_calibration_keeps_frozen_default_plan():
    """Calibrated roofline scales reshape the sweep but cancel in the
    delta at the default config: frozen-default plans are invariant."""
    from repro_torch.core.costmodel import CostParams
    arch = get_arch("granite-3-8b").reduced()
    base = MistTuner(_spec(arch)).tune()
    cp = CostParams(kernels=KernelCoeffs(attn_scale=3.7, rms_scale=0.2,
                                         ssd_scale=11.0))
    scaled = MistTuner(_spec(arch), cp=cp).tune()
    assert base.objective == scaled.objective
    assert base.plan.to_json() == scaled.plan.to_json()


def test_bench_config_caches_by_op_shape_tiles_and_backend(tmp_path):
    """On the CPU the bench times the plain versions, forward and
    backward, and a second call at the same tiles is served from the
    cache."""
    arch = get_arch("zamba2-2.7b").reduced()
    path = tmp_path / "bench.json"
    got = autotune.bench_config(arch, seq_len=128, cache_path=path,
                                device="cpu", reps=1)
    assert set(got) == {"attn", "attn_bwd", "rms", "rms_bwd", "ssd",
                        "ssd_bwd"}
    assert all(v > 0 for v in got.values())
    keys = set(json.loads(path.read_text()))
    assert all(k.split(":")[1] == "cpu" for k in keys)
    assert autotune.bench_config(arch, seq_len=128, cache_path=path,
                                 device="cpu") == got
    other = autotune.bench_config(arch, seq_len=128, cache_path=path,
                                  device="cpu", reps=1,
                                  config=KernelConfig(512, 64, 8, 64))
    assert set(json.loads(path.read_text())) > keys
    assert other.keys() == got.keys()


# -- the plain versions at the menu's tiles, against the reference ------------


def _pair(arr):
    return jnp.asarray(arr), torch.from_numpy(arr)


@pytest.mark.parametrize("kv_block", tiles.MENU["attn_kv_block"])
@pytest.mark.parametrize("hd", [32, 64])
def test_plain_flash_at_menu_tiles_matches_reference(kv_block, hd):
    """The plain flash forward tiled at each kv menu tile against the
    reference's Pallas kernel (interpret mode) at the same tiles, f32
    (tests/test_kernels.py's tolerance)."""
    rng = np.random.default_rng(11)
    b, s, h, kv = 1, 256, 4, 2
    arrs = [rng.standard_normal(sh, dtype=np.float32)
            for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a) for a in arrs)
    got = tops.attention(tq, tk, tv, causal=True, impl="pallas",
                         q_block=128, kv_block=kv_block)
    want = jops.attention(jq, jk, jv, causal=True, impl="pallas",
                          q_block=128, kv_block=kv_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("chunk", tiles.ssd_chunk_menu(16, 16))
def test_plain_ssd_at_menu_chunks_matches_reference(chunk):
    """The plain SSD scan at each chunk of the menu against the reference's
    Pallas kernel (interpret mode) at the same chunk, f32."""
    rng = np.random.default_rng(12)
    b, s, h, p, n = 1, 512, 2, 16, 16
    arrs = dict(
        xh=rng.standard_normal((b, s, h, p), dtype=np.float32),
        dt=np.log1p(np.exp(rng.standard_normal((b, s, h),
                                               dtype=np.float32))),
        a=-np.exp(rng.standard_normal((h,), dtype=np.float32)),
        bb=rng.standard_normal((b, s, h, n), dtype=np.float32),
        cc=rng.standard_normal((b, s, h, n), dtype=np.float32))
    j = {k: _pair(v)[0] for k, v in arrs.items()}
    t = {k: _pair(v)[1] for k, v in arrs.items()}
    got, _ = tops.ssd_scan(t["xh"], t["dt"], t["a"], t["bb"], t["cc"],
                           chunk=chunk)
    want, _ = jops.ssd_scan(j["xh"], j["dt"], j["a"], j["bb"], j["cc"],
                            chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


# -- a tuple outside the menu raises before any launch ------------------------


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers take their CUDA route for CPU tensors; the kernel
    library must not load (a launch would need it)."""
    def refuse():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(FA, "_on_card", lambda t: True)
    monkeypatch.setattr(RN, "_on_card", lambda t: True)
    before = (FA.LAUNCHES, FA.BWD_LAUNCHES, RN.LAUNCHES)
    yield
    assert (FA.LAUNCHES, FA.BWD_LAUNCHES, RN.LAUNCHES) == before


@pytest.mark.parametrize("field,value", [
    ("attn_q_block", 256), ("attn_q_block", 64), ("attn_kv_block", 256),
    ("attn_kv_block", 1024), ("rmsnorm_block", 128), ("rmsnorm_block", 32),
    ("rmsnorm_block", 16)])
def test_tuple_outside_the_menu_raises_before_any_launch(card_route, field,
                                                         value):
    """A plan tile that is neither the default nor a Hopper menu entry
    raises on the CUDA route, with the menu in the message, before the
    kernel library is touched or a launch counted; no value is rounded."""
    with pytest.raises(ValueError, match="Hopper menu"):
        tiles.hopper_tile(field, value)
    q = torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64)
    kc = DEFAULT_KERNEL_CONFIG.replace(**{field: value})
    with pytest.raises(ValueError, match=r"Hopper menu \("):
        if field == "rmsnorm_block":
            RN.rmsnorm(q, torch.ones(32, dtype=torch.bfloat16),
                       block=kc.rmsnorm_block)
        else:
            FA.flash_attention(q, q, q, q_block=kc.attn_q_block,
                               kv_block=kc.attn_kv_block)
    if field != "rmsnorm_block":
        with pytest.raises(ValueError, match="Hopper menu"):
            FA.flash_attention_bwd(q, q, q, q, lse, q,
                                   q_block=kc.attn_q_block,
                                   kv_block=kc.attn_kv_block)


def test_menu_tuples_reach_the_launch_on_the_card_route(card_route):
    """The default and the menu entries pass the tile check and go on to
    the launch (which loads the library, refused here)."""
    q = torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16)
    for kvb in (512,) + tiles.MENU["attn_kv_block"]:
        with pytest.raises(AssertionError, match="library was loaded"):
            FA.flash_attention(q, q, q, kv_block=kvb)
    for rnb in (256,) + tiles.MENU["rmsnorm_block"]:
        with pytest.raises(AssertionError, match="library was loaded"):
            RN.rmsnorm(q, torch.ones(32, dtype=torch.bfloat16), block=rnb)
    assert tiles.hopper_tiles(DEFAULT_KERNEL_CONFIG) == (128, 128, 8, 256)
