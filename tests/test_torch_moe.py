"""MoE parity of the PyTorch port with the JAX reference, on the CPU, at
reduced qwen2-moe-a2.7b (4 layers, d 128, 4 heads of 32 with 4 KV heads and
QKV biases, 4 routed experts top-2 of width 64, one shared expert, vocab
512), in f32.

The reference's init crosses through numpy (``repro_torch.bridge``); the
QKV biases, which the reference initialises to zeros, are drawn non-zero
with numpy and given to both packages, so that a bias left out fails.
Tokens and activations are made with numpy from fixed seeds.

- Routing: the top-k experts, each choice's slot and the keep mask equal
  the reference's exactly (the reference's own routing statements on its
  f32 logits), with drops forced (capacity factor 0.5) and without, in one
  group and in several.
- ``moe()`` output and aux loss, and their gradients, within 2e-5 of each
  tensor's largest value; ``lm_loss`` and every gradient against
  ``jax.value_and_grad`` at 2e-5; CKPT/AO segments bit for bit the port's
  run without remat.
- Attention with the biases in prefill (with the serving cache's k and v)
  and in decode at 2e-5; prefill logits and the greedy decode loop of
  ``generate`` against the reference's, tokens identical.
- A group of 2 x 64 tokens split over two data ranks (simulated: each half
  with its count offsets and the summed top-1 counts) equals one process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import decoder as JDEC
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models.common import ExecConfig as JExecConfig
from repro.models.zoo import pad_caches as jax_pad_caches
from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.models import common as TC
from repro_torch.models import decoder as TDEC
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models.common import ExecConfig
from repro_torch.models.zoo import pad_caches

ARCH = "qwen2-moe-a2.7b"
JCFG = jax_get_arch(ARCH).reduced()
TCFG = get_arch(ARCH).reduced()
B, S = 2, 64
TOL = 2e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x)


def _close(got, want, what="", tol=TOL):
    """|got - want| <= tol * max|want| (per tensor)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def weights():
    """The reference's init in f32 as numpy, with non-zero QKV biases."""
    jparams, _ = JDEC.init_lm(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    w = {n: np.asarray(v) for n, v in jparams.items()}
    rng = np.random.default_rng(3)
    for n in ("bq", "bk", "bv"):
        key = f"layers/attn/{n}"
        w[key] = rng.normal(0.0, 0.5, w[key].shape).astype(np.float32)
    return w


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    toks = rng.integers(0, TCFG.vocab_size, (B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _block(weights, scope, i=0):
    pre = f"layers/{scope}/"
    return {n[len(pre):]: v[i] for n, v in weights.items()
            if n.startswith(pre)}


def _x(seed=11, shape=(B, S, 128)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _reference_routing(router, x, cfg, group):
    """The reference's routing statements (``repro/models/moe.py:43-67``)
    on its f32 logits: (idx, pos, keep) as numpy."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = x.shape[0] * x.shape[1]
    tg = min(group, t)
    g = t // tg
    xg = jnp.asarray(x).reshape(g, tg, x.shape[-1])
    logits = jnp.einsum("gtd,de->gte", xg, jnp.asarray(router),
                        preferred_element_type=jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    oh = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    ohf = oh.reshape(g, tg * k, e)
    pos = jnp.cumsum(ohf, axis=1) - ohf
    pos = (pos.reshape(g, tg, k, e) * oh).sum(-1)
    return (np.asarray(idx), np.asarray(pos),
            np.asarray(pos < JMOE._capacity(tg, cfg)))


def _moe_both(p, x, cf, group, cot):
    """(value, grads) of sum(out * cot) + aux through each package's
    ``moe``, grads of every param and of x."""
    jcfg, tcfg = (JCFG.replace(capacity_factor=cf),
                  TCFG.replace(capacity_factor=cf))
    jec = JExecConfig(compute_dtype=jnp.float32, moe_group_size=group)
    tec = ExecConfig(compute_dtype=torch.float32, moe_group_size=group)

    def jfn(jp, jx):
        out, aux = JMOE.moe(jp, jx, jcfg, jec)
        return jnp.sum(out * cot) + aux, (out, aux)

    (jv, (jout, jaux)), jg = jax.value_and_grad(jfn, argnums=(0, 1),
                                                has_aux=True)(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x))
    tp = {n: t.requires_grad_(True) for n, t in
          bridge.params_from_numpy(p, dtype=torch.float32).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, taux = TMOE.moe(tp, tx, tcfg, tec)
    tv = torch.sum(tout * torch.from_numpy(cot)) + taux
    tv.backward()
    return ((jout, jaux, jg[0], jg[1]),
            (tout, taux, {n: t.grad for n, t in tp.items()}, tx.grad))


@pytest.mark.parametrize("group", [4096, 32])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_routing_output_aux_and_grads_match_reference(weights, cf,
                                                          group):
    """Routing exactly the reference's (drops forced at capacity factor
    0.5), in one group of 128 tokens and in four of 32; output, aux and
    every gradient at 2e-5."""
    p = _block(weights, "moe")
    x = _x()
    cfg = TCFG.replace(capacity_factor=cf)
    r = TMOE.route(torch.from_numpy(x) @ torch.tensor(p["router"]),
                   cfg, ExecConfig(moe_group_size=group))
    idx, pos, keep = _reference_routing(p["router"], x,
                                        JCFG.replace(capacity_factor=cf),
                                        group)
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.cap == TMOE._capacity(min(group, B * S), cfg)
    if cf < 1:
        assert not keep.all(), "capacity factor 0.5 must drop choices"

    cot = _x(12)
    (jout, jaux, jgp, jgx), (tout, taux, tgp, tgx) = _moe_both(
        p, x, cf, group, cot)
    _close(tout, jout, "out")
    _close(taux, jaux, "aux")
    _close(tgx, jgx, "dx")
    assert set(tgp) == set(jgp)
    for n in jgp:
        _close(tgp[n], jgp[n], n)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_attention_with_qkv_biases_matches_reference(weights, mode):
    """The biases added after the projections, before the rotation: the
    prefill's output and the serving cache's k and v (the reference's
    ``_fresh_attn_cache``), and a decode step's output and cache rows."""
    p = _block(weights, "attn")
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    tp = bridge.params_from_numpy(p, dtype=torch.float32)
    jec = JExecConfig(compute_dtype=jnp.float32)
    tec = ExecConfig(compute_dtype=torch.float32)
    if mode == "prefill":
        x = _x(13)
        jout, _ = JL.attention(jp, jnp.asarray(x), JCFG, jec)
        tout, kv = TL.attention(tp, torch.from_numpy(x), TCFG, tec,
                                return_kv=True)
        want = JDEC._fresh_attn_cache(jp, jnp.asarray(x), JCFG)
        for key in ("k", "v"):
            _close(kv[key], want[key], key)
        nobias = {**tp, **{n: torch.zeros_like(tp[n])
                           for n in ("bq", "bk", "bv")}}
        assert not torch.allclose(TL.attention(nobias, torch.from_numpy(x),
                                               TCFG, tec)[0], tout)
    else:
        x = _x(14, (B, 1, 128))
        shape = (B, 16, TCFG.num_kv_heads, TCFG.head_dim)
        ck, cv = _x(15, shape), _x(16, shape)
        pos = 5
        jout, jc = JL.attention(jp, jnp.asarray(x), JCFG, jec, cache={
            "k": jnp.asarray(ck), "v": jnp.asarray(cv),
            "pos": jnp.asarray(pos, jnp.int32)})
        tout, tc = TL.attention(tp, torch.from_numpy(x), TCFG, tec, cache={
            "k": torch.from_numpy(ck.copy()),
            "v": torch.from_numpy(cv.copy()),
            "pos": torch.tensor(pos, dtype=torch.int32)})
        for key in ("k", "v"):
            _close(tc[key], jc[key], key)
    _close(tout, jout, "out")


@pytest.fixture(scope="module")
def jax_loss_and_grads(weights, batch):
    jp = {n: jnp.asarray(v) for n, v in weights.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jec = JExecConfig(compute_dtype=jnp.float32, attn_impl="blocked",
                      attn_kv_block=16)
    fn = jax.jit(jax.value_and_grad(
        lambda p: JDEC.lm_loss(p, jb, JCFG, jec)))
    loss, grads = fn(jp)
    return float(loss), {n: np.asarray(g) for n, g in grads.items()}


def _port_loss_and_grads(weights, batch, **kw):
    tp = {n: t.requires_grad_(True) for n, t in
          bridge.params_from_numpy(weights, dtype=torch.float32).items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ec = ExecConfig(compute_dtype=torch.float32, attn_impl="blocked",
                    attn_kv_block=16, **kw)
    loss = TDEC.lm_loss(tp, tb, TCFG, ec)
    loss.backward()
    return loss.detach(), {n: t.grad for n, t in tp.items()}


def test_lm_loss_and_every_gradient_match_reference(weights, batch,
                                                    jax_loss_and_grads):
    """The whole reduced model, the aux loss included: loss and the
    gradient of every param (the biases, the router, the shared gate)
    against ``jax.value_and_grad`` at 2e-5."""
    jloss, jgrads = jax_loss_and_grads
    loss, grads = _port_loss_and_grads(weights, batch)
    np.testing.assert_allclose(float(loss), jloss, rtol=TOL)
    assert set(grads) == set(jgrads)
    for n, g in jgrads.items():
        _close(grads[n], g, n)


@pytest.mark.parametrize("ckpt, off", [(2, 0), (4, 1), (4, 4)])
def test_remat_and_offload_segments_are_bitwise_the_plain_run(
        weights, batch, jax_loss_and_grads, ckpt, off):
    """CKPT/AO segments recompute the same CPU ops (the routing with them):
    loss and every gradient equal the run without remat bit for bit, and
    the reference's at 2e-5."""
    base_loss, base = _port_loss_and_grads(weights, batch, ckpt_layers=0)
    before = TC.OFFLOADED_BYTES
    loss, grads = _port_loss_and_grads(weights, batch, ckpt_layers=ckpt,
                                       offload_layers=off)
    assert TC.OFFLOADED_BYTES - before == off * B * S * TCFG.d_model * 4
    assert torch.equal(loss, base_loss)
    for n, g in base.items():
        assert torch.equal(grads[n], g), n
    np.testing.assert_allclose(float(loss), jax_loss_and_grads[0], rtol=TOL)


def test_prefill_logits_and_greedy_decode_match_reference(weights):
    """f32 prefill logits and caches at 2e-5, then the greedy loop of
    ``generate`` (prefill, then one decode step a token) through both
    packages: tokens identical, logits at 2e-5.  A decode step routes its
    B tokens as one group (capacity 4).  (Both packages' ``generate``
    runs its serve plan in bf16, where greedy tokens may flip at
    near-ties: ``tests/test_torch_serve.py``'s margin rule.)"""
    jp = {n: jnp.asarray(v) for n, v in weights.items()}
    tp = bridge.params_from_numpy(weights, dtype=torch.float32)
    prompts = np.random.default_rng(21).integers(
        0, TCFG.vocab_size, (4, 12), dtype=np.int32)
    gen = 6
    jec = JExecConfig(compute_dtype=jnp.float32, ckpt_layers=0,
                      remat_policy="none")
    tec = ExecConfig(compute_dtype=torch.float32, ckpt_layers=0,
                     remat_policy="none")
    jl, jc = JDEC.lm_prefill(jp, {"tokens": jnp.asarray(prompts)}, JCFG,
                             jec, return_cache=True)
    tl, tc = TDEC.lm_prefill(tp, {"tokens": torch.from_numpy(prompts)},
                             TCFG, tec, return_cache=True)
    _close(tl, jl, "prefill logits")
    for key in ("k", "v"):
        _close(tc[key], jc[key], key)
    jc, tc = jax_pad_caches(jc, gen), pad_caches(tc, gen)
    for step in range(gen):
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        ttok = tl[:, -1].argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), jtok, err_msg=f"{step}")
        jl, jc = JDEC.lm_decode(jp, jnp.asarray(jtok)[:, None], jc, JCFG,
                                jec)
        tl, tc = TDEC.lm_decode(tp, ttok[:, None], tc, TCFG, tec)
        _close(tl, jl, f"decode step {step}")


class _TwoDataRanks:
    """``torch.distributed`` as the MoE's routing calls it on data rank
    ``rank`` of two whose group of 2 x 64 tokens is split between them:
    ``all_reduce`` adds the other rank's recorded top-1 counts and
    ``all_gather_into_tensor`` lays out both ranks' recorded expert counts;
    the tp group is one rank.  Pass 1 (nothing recorded) records them."""

    class ReduceOp:
        SUM = "sum"

    def __init__(self, rank, book):
        self.rank, self.book = rank, book

    def all_reduce(self, t, op=None, group=None):
        if group == "dp":
            self.book.setdefault(("top1", self.rank), t.clone())
            other = self.book.get(("top1", 1 - self.rank))
            if other is not None:
                t.add_(other)

    def all_gather_into_tensor(self, out, t, group=None):
        assert group == "dp"
        self.book.setdefault(("counts", self.rank), t.clone())
        for r in range(2):
            out[r * t.numel():(r + 1) * t.numel()] = \
                self.book.get(("counts", r), t)

    def get_world_size(self, group=None):
        return 2 if group == "dp" else 1


def test_a_group_split_over_two_data_ranks_equals_one_process(
        weights, monkeypatch):
    """One group of 2 x 64 tokens (capacity factor 0.5, so that the slots
    decide drops) over two data ranks of one sequence each: every rank's
    slots offset by the earlier rank's expert counts, the aux's top-1
    counts summed; the ranks' routing and outputs concatenated, and the
    mean of their aux losses, equal one process's."""
    cfg = TCFG.replace(capacity_factor=0.5)
    p = bridge.params_from_numpy(_block(weights, "moe"), dtype=torch.float32)
    x = torch.from_numpy(_x())
    ec = ExecConfig(compute_dtype=torch.float32)
    whole = TMOE.route(x @ p["router"], cfg, ec)
    want_out, want_aux = TMOE.moe(p, x, cfg, ec)
    book = {}
    for _ in range(2):                 # pass 1 records the counts
        got = []
        for rank in range(2):
            fake = _TwoDataRanks(rank, book)
            monkeypatch.setattr(TMOE, "dist", fake)
            monkeypatch.setattr(TC, "dist", fake)
            par = TC.Parallel("dp", "tp", 2, 1, rank, 0, sp=False)
            rec = ec.replace(par=par)
            xr = x[rank:rank + 1]
            got.append((TMOE.route(xr @ p["router"], cfg, rec),
                        TMOE.moe(p, xr, cfg, rec)))
    for f in ("idx", "pos", "keep"):
        assert torch.equal(torch.cat([getattr(r, f) for r, _ in got], 1),
                           getattr(whole, f)), f
    assert not whole.keep.all()
    torch.testing.assert_close(torch.cat([o for _, (o, _) in got]),
                               want_out, rtol=0, atol=1e-6)
    torch.testing.assert_close((got[0][1][1] + got[1][1][1]) / 2, want_aux,
                               rtol=1e-6, atol=0)
