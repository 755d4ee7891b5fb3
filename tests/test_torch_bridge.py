"""Weights, caches and plans cross between the JAX reference and the
PyTorch port with identical names, shapes and bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core.plan import KernelConfig as JKernelConfig
from repro.core.plan import single_stage_plan as jax_plan
from repro.models import decoder as JDEC
from repro.models.common import ExecConfig as JExecConfig
from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.core.plan import KernelConfig, Plan, single_stage_plan
from repro_torch.models import decoder as TDEC

ARCH = "granite-3-8b"
JCFG = jax_get_arch(ARCH).reduced()
TCFG = get_arch(ARCH).reduced()
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(x):
    """Raw bits of a JAX array or torch tensor, for exact comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint8 if x.dtype == torch.uint8 else
                              np.dtype(f"u{x.element_size()}"))
    a = np.asarray(x)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def test_config_copy_matches_reference():
    assert TCFG == TCFG.replace()
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "rope_theta",
                  "tie_embeddings", "norm_type", "act", "mlp_gated"):
        assert getattr(TCFG, field) == getattr(JCFG, field), field
        assert getattr(get_arch(ARCH), field) == \
            getattr(jax_get_arch(ARCH), field), field


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_params_round_trip_names_shapes_bits(dtype):
    jdt, tdt = DTYPES[dtype]
    jparams, _ = JDEC.init_lm(jax.random.PRNGKey(0), JCFG, dtype=jdt)
    flat = {n: np.asarray(v.astype(jnp.float32)) for n, v in jparams.items()}
    tparams = bridge.params_from_numpy(flat, dtype=tdt)
    # every reference key maps to exactly one port tensor
    assert sorted(tparams) == sorted(jparams)
    for name, jv in jparams.items():
        tv = tparams[name]
        assert tuple(tv.shape) == jv.shape and tv.dtype == tdt, name
        np.testing.assert_array_equal(_bits(tv), _bits(jv), err_msg=name)
    back = bridge.params_to_numpy(tparams)
    for name in flat:
        np.testing.assert_array_equal(back[name], flat[name], err_msg=name)


def test_port_init_has_reference_names_shapes_and_scales():
    jparams, jaxes = JDEC.init_lm(jax.random.PRNGKey(0), JCFG,
                                  dtype=jnp.float32)
    tparams, taxes = TDEC.init_lm(TCFG, torch.Generator().manual_seed(0),
                                  torch.float32, "cpu")
    assert sorted(tparams) == sorted(jparams)
    assert taxes == {n: tuple(a) for n, a in jaxes.items()}
    for name, jv in jparams.items():
        tv = tparams[name]
        assert tuple(tv.shape) == jv.shape, name
        jstd, tstd = float(jnp.std(jv)), float(tv.std())
        if jstd == 0.0:   # ones / zeros init
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        else:             # normal init: same scale within sampling noise
            assert abs(tstd / jstd - 1.0) < 0.05, (name, tstd, jstd)


@pytest.mark.parametrize("arch", ["granite-3-8b", "zamba2-2.7b"])
def test_port_init_draws_stacked_params_one_layer_at_a_time(arch,
                                                            monkeypatch):
    """One draw per stacked layer (``L`` for the dense stack, groups x
    per-group for the hybrid's), one for every other normal-init param: at
    full width a draw per row of the last two dims made granite-3-8b's
    q/k/v projections 163,840 draws."""
    from repro_torch.models.zoo import build_model
    cfg = get_arch(arch).reduced()
    shapes = []
    real = torch.randn

    def counting_randn(*shape, **kw):
        shapes.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return real(*shape, **kw)

    monkeypatch.setattr(torch, "randn", counting_randn)
    params, axes = build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0), torch.float32)
    monkeypatch.undo()
    want = []
    for name, ax in axes.items():
        if float(params[name].std()) == 0.0:     # ones / zeros init
            continue
        lead = next((i for i, a in enumerate(ax)
                     if not (a or "").startswith("layers")), len(ax))
        shape = tuple(params[name].shape)
        n = int(np.prod(shape[:lead])) if lead else 1
        want += [shape[lead:]] * n
    assert sorted(shapes) == sorted(want)
    assert max(len(s) for s in shapes) <= 3


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_caches_round_trip(dtype):
    jdt, tdt = DTYPES[dtype]
    jparams, _ = JDEC.init_lm(jax.random.PRNGKey(0), JCFG, dtype=jdt)
    toks = np.random.default_rng(0).integers(0, JCFG.vocab_size, (2, 8),
                                             dtype=np.int32)
    ec = JExecConfig(ckpt_layers=0, remat_policy="none", compute_dtype=jdt)
    _, jc = JDEC.lm_prefill(jparams, {"tokens": jnp.asarray(toks)}, JCFG, ec,
                            return_cache=True)
    tree = {k: np.asarray(v.astype(jnp.float32)) if k != "pos"
            else np.asarray(v) for k, v in jc.items()}
    tc = bridge.caches_from_numpy(tree, dtype=tdt)
    assert sorted(tc) == sorted(jc) == ["k", "pos", "v"]
    assert tc["pos"].dtype == torch.int32
    for key in ("k", "v", "pos"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_array_equal(_bits(tc[key]), _bits(jc[key]),
                                      err_msg=key)
    back = bridge.caches_to_numpy(tc)
    for key in tree:
        np.testing.assert_array_equal(back[key], tree[key], err_msg=key)


@pytest.mark.parametrize("kernel", [None, (256, 128, 512, 64)])
def test_plan_json_crosses_byte_identically(kernel):
    kw = dict(dp=1, tp=1, micro_batch=2, grad_accum=4, zero=1, ao=0.5,
              attn_impl="pallas", use_pallas=True)
    jp = jax_plan(40, **kw)
    tp = single_stage_plan(40, **kw)
    if kernel:
        jp = jp.replace(kernel=JKernelConfig(*kernel))
        tp = tp.replace(kernel=KernelConfig(*kernel))
    assert tp.to_json() == jp.to_json()
    assert Plan.from_json(jp.to_json()) == tp
