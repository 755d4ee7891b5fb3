"""Training parity of the PyTorch port's hybrid (zamba2-2.7b reduced: 8
Mamba2 layers in 2 groups of 4, d 128, SSD heads of 16 with state 16) with
the JAX reference, on the CPU.

The same weights (the reference's init, crossed through numpy by
``repro_torch.bridge``) and the same numpy-made batches go through both
packages.  The SSD chunk is 16, so the 64-token sequences span four chunks
and the state and its gradient carry.  The reference differentiates only
its jnp ``ssd_chunked`` (its Pallas SSD has no VJP), so every gradient is
held against ``jax.value_and_grad`` with ``use_pallas=False``; the port runs
with ``use_pallas`` off (autograd through the chunked algebra) and on (the
SSD autograd Function, whose CPU route is ``ssd_plain`` and
``ssd_bwd_plain``).

Tolerances (docs/port.md):
- ``ssd_bwd_plain``: against autograd through ``ssd_plain`` and against
  ``jax.grad`` through the reference's ``ssd_chunked``, f32, 2e-4 of each
  gradient's largest value (the reference's SSD tolerance).
- ``hybrid_loss`` at f32: loss 1e-5 relative, every gradient 1e-4 of its
  largest value; within the port every CKPT/AO case equals the run
  without remat bit for bit.
- bf16: the loss within 1e-2 of the reference's bf16 loss, and the
  per-token losses' error against the port's own f32 run at most 1.5x the
  reference's bf16 error against its f32 run, in max and in mean
  (``ACCURACY_ROOM``).
- one train step at f32: params and master within 1e-6 of the
  reference's on average, and elementwise within half the learning rate
  wherever the reference's gradient is farther from zero than the gradient
  tolerance (elsewhere the sign of g, and so Adam's first update, may go
  either way: within 2 lr); mu and nu within 1e-4 of their largest value.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs.base import get_arch as jax_get_arch
from repro.core.plan import single_stage_plan as jax_plan
from repro.launch.mesh import make_host_mesh
from repro.lowering import lower_plan
from repro.models import hybrid as JHY
from repro.models import ssm as JSSM
from repro.models.common import ExecConfig as JExecConfig
from repro.training import optimizer as JOPT
from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.core.plan import KernelConfig, Plan
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models import common as TC
from repro_torch.models import hybrid as THY
from repro_torch.models.common import ExecConfig
from repro_torch.models.zoo import build_model
from repro_torch.training import optimizer as TOPT
from repro_torch.training.checkpoint import (Checkpointer, StatePlacement,
                                             _flatten)
from repro_torch.training.data import BatchSpec, SyntheticLM
from repro_torch.training.loop import LoopConfig, TrainLoop
from repro_torch.training.step import (grad_sums, init_train_state,
                                       make_train_step, micro_steps)

ARCH = "zamba2-2.7b"
JCFG = jax_get_arch(ARCH).reduced()
TCFG = get_arch(ARCH).reduced()
B, S, CHUNK = 2, 64, 16
PER = TCFG.shared_attn_every
ACCURACY_ROOM = 1.5


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors must never reach the CUDA library."""
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel loader")
    monkeypatch.setattr(_build, "load_library", refuse)
    SS.LAUNCHES = SS.BWD_LAUNCHES = 0
    yield
    assert SS.LAUNCHES == 0 and SS.BWD_LAUNCHES == 0


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


def _bits(t):
    """A tensor's bits, as integers of its width."""
    return t.view({torch.bfloat16: torch.int16,
                   torch.float32: torch.int32}.get(t.dtype, t.dtype))


def _jec(jdt=jnp.float32, **kw):
    return JExecConfig(compute_dtype=jdt, attn_impl="blocked",
                       attn_kv_block=16, ssd_chunk=CHUNK, **kw)


def _tec(tdt=torch.float32, **kw):
    return ExecConfig(compute_dtype=tdt, attn_impl="blocked",
                      attn_kv_block=16, ssd_chunk=CHUNK, **kw)


@pytest.fixture(scope="module")
def weights():
    """The reference's reduced-zamba2 init in f32, as numpy."""
    jparams, _ = JHY.init_hybrid(jax.random.PRNGKey(0), JCFG,
                                 dtype=jnp.float32)
    return {n: np.asarray(v) for n, v in jparams.items()}


def _batch(seed, b=B):
    toks = np.random.default_rng(seed).integers(
        0, TCFG.vocab_size, (b, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def batch():
    return _batch(7)


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """The reference's jitted value_and_grad of hybrid_loss at f32 (its
    jnp SSD route), compiled once for the module."""
    return jax.jit(jax.value_and_grad(
        lambda p, b: JHY.hybrid_loss(p, b, JCFG, _jec())))


@pytest.fixture(scope="module")
def jax_grads(weights, batch, jax_value_and_grad):
    loss, g = jax_value_and_grad({n: jnp.asarray(v)
                                  for n, v in weights.items()},
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {n: np.asarray(v) for n, v in g.items()}


def _port_loss_and_grads(weights, batch, ec, dtype=torch.float32):
    params = bridge.params_from_numpy(weights, dtype=dtype)
    for t in params.values():
        t.requires_grad_(True)
    loss = THY.hybrid_loss(params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, TCFG, ec)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


# -- the SSD backward's plain version -----------------------------------------

SSD_CASES = {  # (B, S, H, P, N, G, chunk, dt/a scale)
    "chunks_g1": (2, 64, 4, 16, 8, 1, 16, 1.0),
    "chunks_g2": (1, 48, 4, 8, 8, 2, 16, 1.0),
    "one_chunk": (2, 32, 2, 8, 4, 1, 32, 1.0),
    "large_dta": (1, 48, 2, 8, 8, 1, 16, 30.0),
}


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_bwd_plain_matches_autograd_and_reference(case):
    """``ssd_bwd_plain`` against autograd through ``ssd_plain`` and against
    jax.grad through the reference's jnp ``ssd_chunked`` (B/C repeated over
    the heads of each group, its gradient summed back per group), f32;
    finite at large |dt a|, where masking after the exp would give NaN."""
    b, s, h, p, n, g, q, scale = SSD_CASES[case]
    rng = np.random.default_rng(3)
    arrs = dict(
        xh=rng.standard_normal((b, s, h, p), dtype=np.float32),
        dt=scale * np.log1p(np.exp(rng.standard_normal((b, s, h),
                                                       dtype=np.float32))),
        a=-scale * np.exp(rng.standard_normal((h,), dtype=np.float32)),
        bb=rng.standard_normal((b, s, g, n), dtype=np.float32),
        cc=rng.standard_normal((b, s, g, n), dtype=np.float32))
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in arrs.items()}
    got = SS.ssd_bwd_plain(*(t[k].detach() for k in arrs),
                           torch.from_numpy(dy), q)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    y, _ = SS.ssd_plain(*t.values(), q)
    auto = torch.autograd.grad(y, list(t.values()), torch.from_numpy(dy))
    names = ("dx", "ddt", "da", "dbb", "dcc")
    for name, x, w in zip(names, got, auto):
        assert x.dtype == torch.float32
        _close_scaled(x, w, 2e-4, f"{name} vs autograd")

    rep = h // g

    def jloss(xh, dt, a, bb, cc):
        y, _ = JSSM.ssd_chunked(xh, dt, a, jnp.repeat(bb, rep, axis=2),
                                jnp.repeat(cc, rep, axis=2), q)
        return jnp.sum(y * dy)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(arrs[k]) for k in arrs))
    for name, x, w in zip(names, got, want):
        _close_scaled(x, w, 2e-4, f"{name} vs reference")


def test_ssd_function_grads_are_the_plain_backward():
    """Through ``ops.ssd_scan`` (the autograd Function) on CPU tensors the
    gradient is ``ssd_bwd_plain``'s, bit for bit; hT carries none."""
    rng = np.random.default_rng(4)
    b, s, h, p, n, g = 1, 48, 4, 8, 8, 2
    ins = [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
           for sh in ((b, s, h, p), (b, s, h), (h,), (b, s, g, n),
                      (b, s, g, n))]
    ins[1] = torch.nn.functional.softplus(ins[1])
    ins[2] = -torch.exp(ins[2])
    leaves = [x.clone().requires_grad_(True) for x in ins]
    y, hT = ops.ssd_scan(*leaves, chunk=16, return_state=True)
    assert y.grad_fn is not None and not hT.requires_grad
    dy = torch.from_numpy(rng.standard_normal(y.shape, dtype=np.float32))
    got = torch.autograd.grad(y, leaves, dy)
    want = SS.ssd_bwd_plain(*ins, dy, 16)
    for x, w in zip(got, want):
        assert torch.equal(x, w)


def test_cuda_wrapper_refuses_grad_inputs_outside_the_function(monkeypatch):
    """On the card (the device check patched to say so) the wrapper raises
    before any launch for inputs that require grad, unless the call comes
    through the Function (or autograd is off); the Function's backward
    reaches the backward launch with the forward's states."""
    calls = []

    def fake_launch(xh, dt, a, bb, cc, q):
        calls.append("fwd")
        y, hT = SS.ssd_plain(xh, dt, a, bb, cc, q)
        nc = xh.shape[1] // q
        return y, hT, torch.zeros(SS.state_scratch_shape(
            xh.shape[0], xh.shape[2], nc, xh.shape[3], bb.shape[3]))

    def fake_bwd(xh, dt, a, bb, cc, dy, states, q):
        calls.append(("bwd", tuple(states.shape)))
        return SS.ssd_bwd_plain(xh, dt, a, bb, cc, dy, q)

    monkeypatch.setattr(SS, "_on_card", lambda t: True)
    monkeypatch.setattr(SS, "_launch", fake_launch)
    monkeypatch.setattr(SS, "_launch_bwd", fake_bwd)
    b, s, h, p, n = 1, 32, 2, 8, 4
    ins = [torch.randn(b, s, h, p), torch.rand(b, s, h), -torch.rand(h),
           torch.randn(b, s, 1, n), torch.randn(b, s, 1, n)]
    leaves = [x.clone().requires_grad_(True) for x in ins]
    with pytest.raises(RuntimeError, match="autograd Function"):
        SS.ssd_scan(*leaves, chunk=16)
    assert calls == []
    with torch.no_grad():
        SS.ssd_scan(*leaves, chunk=16)
    y, _ = ops.ssd_scan(*leaves, chunk=16)
    y.sum().backward()
    assert calls == ["fwd", "fwd", ("bwd", (1, b, h, n, p))]
    assert all(x.grad is not None for x in leaves)


def test_backward_wrapper_mirrors_the_kernel_and_raises_before_launch():
    """The wrapper's backward constants are the source's; its shared memory
    fits zamba2's chunk 256 at P = N = 64 in bf16 (one block of 16 warps
    an SM) and every bf16 shape the kernel takes, and f32 up to chunk 128;
    the parts scratch holds one f32 dB / dC row per cluster of heads, as
    the kernel writes and its second kernel reads it (1/8 of the per-head
    traffic at zamba2's training shape); and a shape that does not fit
    raises before the library loads (the autouse fixture fails the test if
    it does)."""
    src = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    for name, want in (("THREADS", SS.BWD_THREADS), ("TILE", SS.BWD_TILE),
                       ("TC_WARPS", SS.BWD_TC_WARPS),
                       ("ROW_BLOCK", SS.ROW_BLOCK),
                       ("SMEM_PAD", SS.SMEM_PAD),
                       ("STAGE_PAD", SS.BWD_STAGE_PAD),
                       ("MAX_CLUSTER", SS.BWD_MAX_CLUSTER),
                       ("TC_THREADS", 32 * SS.BWD_TC_WARPS)):
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert [int(v) for v in found] == [want], name
    assert "constexpr int MAX_ROWS = TC_WARPS * ROW_BLOCK;" in src
    assert SS.BWD_MAX_CHUNK == 256
    # x, dy, B, C (147,456 B; the f32 dB / dC staging reuses it), dH and
    # H_in as hi + lo, nine vectors and the block's words
    assert SS.bwd_smem_bytes(256, 64, 64) == 147456 + 36864 + 4 * (
        9 * 256 + 16 + 4) == 193616 <= SS.SMEM_LIMIT
    assert 2 * SS.bwd_smem_bytes(256, 64, 64) > SS.SMEM_LIMIT
    for q in (16, 40, 96, 256):
        for p in SS.TC_DIMS:
            for n in SS.TC_DIMS:
                assert SS.bwd_smem_bytes(q, p, n) <= SS.SMEM_LIMIT
    assert SS.bwd_smem_bytes(128, 64, 64, torch.float32) <= SS.SMEM_LIMIT
    assert SS.bwd_smem_bytes(256, 64, 64, torch.float32) > SS.SMEM_LIMIT
    # clusters: the most heads of a group up to 8, a power of 2; f32 one
    assert [SS.bwd_cluster(h, g) for h, g in
            ((80, 1), (8, 2), (4, 1), (6, 3), (12, 1), (2, 2))] == \
        [8, 4, 4, 2, 4, 1]
    assert SS.bwd_cluster(80, 1, torch.float32) == 1
    assert SS.bwd_parts_shape(1, 4096, 80, 1, 64) == (2, 1, 4096, 10, 64)
    assert SS.bwd_parts_shape(1, 4096, 80, 1, 64, torch.float32) == \
        (2, 1, 4096, 80, 64)
    parts_bytes = 4 * math.prod(SS.bwd_parts_shape(1, 4096, 80, 1, 64))
    per_head = 4 * math.prod(SS.bwd_parts_shape(1, 4096, 80, 1, 64,
                                                torch.float32))
    assert 2 * parts_bytes == 41_943_040 == 2 * per_head // 8
    # the kernels' indexing of the parts, replayed: rank r of the cluster
    # of heads hc writes rows [r Qp / CL, (r + 1) Qp / CL) of (which, b,
    # c0 + row, hc) once; the reduce sums a group's H / (G CL) parts
    assert "part_row = static_cast<long long>(HC) * N" in src
    assert "const int HC = args.H / args.CL, rep = HC / args.G;" in src
    for bsz, s, h, g, n, q in ((2, 192, 8, 2, 16, 96), (1, 40, 6, 3, 32, 40),
                               (1, 512, 80, 1, 16, 256)):
        cl, hcn = SS.bwd_cluster(h, g), h // SS.bwd_cluster(h, g)
        qp = -(-q // SS.ROW_BLOCK) * SS.ROW_BLOCK
        shape = SS.bwd_parts_shape(bsz, s, h, g, n)
        hits = torch.zeros(shape, dtype=torch.int32).reshape(-1)
        for which in range(2):
            for b in range(bsz):
                for c0 in range(0, s, q):
                    for hc in range(hcn):
                        for rank in range(cl):
                            rows = range(rank * qp // cl,
                                         (rank + 1) * qp // cl)
                            for row in (r for r in rows if r < q):
                                off = (((which * bsz + b) * s + c0 + row)
                                       * hcn + hc) * n
                                hits[off:off + n] += 1
        assert bool((hits == 1).all()), (bsz, s, h, g, n, q)
        parts = torch.randn(shape)
        flat = parts.reshape(-1)
        rep = hcn // g
        for which, b, row, grp in ((1, bsz - 1, s - 1, g - 1), (0, 0, 0, 0)):
            src_off = ((which * bsz + b) * s + row) * hcn * n + grp * rep * n
            got = sum(flat[src_off + r * n:src_off + r * n + n]
                      for r in range(rep))
            assert torch.allclose(got, parts[which, b, row, grp * rep:
                                             (grp + 1) * rep].sum(0))
    x = torch.zeros(1, 512, 2, 64)
    bc = torch.zeros(1, 512, 1, 64)
    states = torch.zeros(SS.state_scratch_shape(1, 2, 2, 64, 64))
    with pytest.raises(ValueError, match="shared"):
        SS._launch_bwd(x, torch.zeros(1, 512, 2), torch.zeros(2), bc, bc, x,
                       states, 256)
    xb, bcb = x.to(torch.bfloat16), bc.to(torch.bfloat16)
    with pytest.raises(ValueError, match="chunks of up to 256"):
        SS._launch_bwd(xb, torch.zeros(1, 512, 2), torch.zeros(2), bcb, bcb,
                       xb, torch.zeros(SS.state_scratch_shape(1, 2, 1, 64,
                                                              64)), 512)
    wide = torch.zeros(1, 512, 1, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):
        SS._launch_bwd(xb, torch.zeros(1, 512, 2), torch.zeros(2), wide,
                       bcb, xb, states, 256)
    with pytest.raises(ValueError, match="bf16 kernel takes"):
        x40 = torch.zeros(1, 512, 2, 40, dtype=torch.bfloat16)
        SS._launch_bwd(x40, torch.zeros(1, 512, 2), torch.zeros(2), bcb,
                       bcb, x40, torch.zeros(SS.state_scratch_shape(
                           1, 2, 2, 40, 64)), 256)


# -- hybrid_loss ---------------------------------------------------------------

# (ckpt_layers, offload_layers): none, part (ceil(3 / 4) = 1 group), all,
# and all with one group offloading its input
SEGMENTS = [(0, 0), (3, 0), (8, 0), (8, 4)]


@pytest.fixture(scope="module")
def port_no_remat(weights, batch):
    return {up: _port_loss_and_grads(weights, batch,
                                     _tec(ckpt_layers=0, use_pallas=up))
            for up in (False, True)}


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["algebra", "ssd_function"])
@pytest.mark.parametrize("ckpt,off", SEGMENTS)
def test_hybrid_loss_and_grads_match_reference(weights, batch, jax_grads,
                                               port_no_remat, use_pallas,
                                               ckpt, off):
    """Loss and every gradient of ``hybrid_loss`` against
    jax.value_and_grad(hybrid_loss) at f32, CKPT and AO counted in groups;
    bitwise equal to the port's run without remat; the offload hook took
    one residual stream per offloaded group."""
    ec = _tec(ckpt_layers=ckpt, offload_layers=off, use_pallas=use_pallas)
    before = TC.OFFLOADED_BYTES
    loss, grads = _port_loss_and_grads(weights, batch, ec)
    groups_off = -(-off // PER)
    assert TC.OFFLOADED_BYTES - before == groups_off * B * S * \
        TCFG.d_model * 4
    want_loss, want = jax_grads
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    assert set(grads) == set(want)
    for n, g in grads.items():
        _close_scaled(g, want[n], 1e-4, n)
    base_loss, base = port_no_remat[use_pallas]
    assert torch.equal(loss, base_loss)
    for n, g in grads.items():
        assert torch.equal(g, base[n]), n


@pytest.mark.parametrize("ckpt,off", [(0, 0), (3, 0), (8, 4)])
def test_remat_reruns_the_forward_kernels_of_each_remat_group(
        weights, batch, monkeypatch, ckpt, off):
    """Non-reentrant checkpoint recomputes a remat'd group up to its last
    Mamba layer's saved tensors: its two shared-block norms, its attention,
    its Mamba norms and its SSD scans rerun.  Per loss and backward, with
    ng groups of ``per`` layers and cg of them remat'd: flash forward ng +
    cg, RMSNorm forward 2 ng + L + 1 + cg (2 + per), SSD forward L + cg
    per, and one backward of each per forward of the saved graph (the
    count chip_smoke.py's phase H holds the kernels to)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    calls = dict.fromkeys(("fa", "fa_bwd", "rn", "rn_bwd", "ssd", "ssd_bwd"),
                          0)

    def counted(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    for mod, name, key in ((FA, "flash_attention", "fa"),
                           (FA, "flash_attention_bwd", "fa_bwd"),
                           (RN, "rmsnorm", "rn"), (RN, "rmsnorm_bwd",
                                                   "rn_bwd"),
                           (SS, "ssd_plain", "ssd"),
                           (SS, "ssd_bwd_plain", "ssd_bwd")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    L, ng = TCFG.num_layers, TCFG.num_layers // PER
    cg = -(-ckpt // PER)
    ec = ExecConfig(compute_dtype=torch.float32, attn_impl="pallas",
                    use_pallas=True, ssd_chunk=CHUNK, ckpt_layers=ckpt,
                    offload_layers=off)
    _port_loss_and_grads(weights, batch, ec)
    assert calls == {"fa": ng + cg, "fa_bwd": ng,
                     "rn": 2 * ng + L + 1 + cg * (2 + PER),
                     "rn_bwd": 2 * ng + L + 1, "ssd": L + cg * PER,
                     "ssd_bwd": L}


def test_sink_sums_each_use_once_also_under_recompute(weights, batch,
                                                      port_no_remat):
    """A train step's ``GradSink`` (no param a leaf): each use -- the
    shared block once per group, each group's in-proj, each (g, l) Mamba
    slice -- adds its gradient once, with and without recompute: the sums
    equal bit for bit, and equal the autograd leaves' gradients."""
    model = build_model(TCFG, "cpu")
    params = bridge.params_from_numpy(weights)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    sums = {}
    for ckpt, off in ((0, 0), (8, 4)):
        sink = TC.GradSink(grad_sums(params))
        micro_steps(model, params, [tb],
                    _tec(ckpt_layers=ckpt, offload_layers=off,
                         use_pallas=True), sink)
        sums[ckpt] = sink.sums
    _, auto = port_no_remat[True]
    for n in params:
        assert torch.equal(sums[0][n], sums[8][n]), n
        _close_scaled(sums[0][n], auto[n], 1e-6, n)
    assert all(p.grad is None for p in params.values())


def test_bf16_loss_as_accurate_as_reference(weights, batch):
    """bf16: the loss within 1e-2 of the reference's bf16 loss, and the
    per-token losses held against the port's own f32 run no less
    accurately than the reference's bf16 run against its f32 run."""
    def jax_tokens(jdt):
        p = {n: jnp.asarray(v).astype(jdt) for n, v in weights.items()}
        x = jnp.take(p["embed/w"], jnp.asarray(batch["tokens"]), axis=0)
        h = JHY.run_hybrid_layers(p, x.astype(jdt), JCFG, _jec(jdt))
        logits = (h @ p["lm_head/w"]).astype(jnp.float32)
        return np.asarray(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
            logits, jnp.asarray(batch["labels"])[..., None], -1)[..., 0])

    def port_tokens(tdt):
        p = bridge.params_from_numpy(weights, dtype=tdt)
        ec = _tec(tdt, ckpt_layers=0, use_pallas=True)
        with torch.no_grad():
            x = p["embed/w"][torch.from_numpy(batch["tokens"]).long()]
            h = THY.run_hybrid_layers(p, x, TCFG, ec)
            logits = (h @ p["lm_head/w"]).float()
            gold = torch.gather(logits, -1, torch.from_numpy(
                batch["labels"]).long()[..., None])[..., 0]
            loss = THY.hybrid_loss(p, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, TCFG, ec)
        return (torch.logsumexp(logits, -1) - gold).numpy(), float(loss)

    want = jax_tokens(jnp.bfloat16)
    truth_ref = jax_tokens(jnp.float32)
    got, loss = port_tokens(torch.bfloat16)
    truth, _ = port_tokens(torch.float32)
    assert np.isfinite(got).all()
    assert abs(loss - float(want.mean())) <= 1e-2 * abs(float(want.mean()))
    err, ref_err = np.abs(got - truth), np.abs(want - truth_ref)
    assert err.max() <= ACCURACY_ROOM * ref_err.max(), (err.max(),
                                                        ref_err.max())
    assert err.mean() <= ACCURACY_ROOM * ref_err.mean(), (err.mean(),
                                                          ref_err.mean())


# -- the train step, its state, the bridge and the checkpointer ----------------

def _plan():
    """G 2 micro-batches of 1, CKPT 5 of 8 layers (2 groups), AO 0.2 of
    them (1 layer: 1 group), WO = OO = 0.5, the SSD kernel route."""
    return dict(dp=1, tp=1, micro_batch=1, grad_accum=2, zero=1,
                ckpt_layers=5, ao=0.2, wo=0.5, oo=0.5, attn_impl="pallas",
                use_pallas=True)


@pytest.fixture(scope="module")
def stepped(weights, jax_value_and_grad):
    """One make_train_step at f32 in the port and the reference's
    value_and_grad over the same two micro-batches plus its adam_update,
    from the same state."""
    batch = _batch(11)
    jplan = jax_plan(JCFG.num_layers, **_plan())
    stage = jplan.stages[0]
    _, axes = JHY.init_hybrid(jax.random.PRNGKey(0), JCFG, abstract=True)
    mesh = make_host_mesh(1, 1)
    with compat.set_mesh(mesh):
        shardings = lower_plan(JCFG, None, jplan, mesh).state_shardings()
    jp = {n: jnp.asarray(v) for n, v in weights.items()}
    jstate = jax.device_put(JOPT.init_state(jp, axes, stage), shardings)
    gsum = None
    for i in range(2):
        micro = {k: jnp.asarray(v[i:i + 1]) for k, v in batch.items()}
        _, g = jax_value_and_grad(jp, micro)
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
    jstate, jm = jax.jit(lambda st, g: JOPT.adam_update(
        st, g, JOPT.AdamConfig(), shardings))(
            jstate, jax.tree.map(lambda x: x / 2, gsum))
    plan = Plan.from_json(jplan.to_json()).replace(
        kernel=KernelConfig(ssd_chunk=CHUNK))
    model = build_model(TCFG, "cpu")
    tstate = TOPT.init_state(bridge.params_from_numpy(weights), axes,
                             plan.stages[0])
    tstate, tm = make_train_step(model, plan).fn(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    jgrad = {n: np.asarray(v) / 2 for n, v in gsum.items()}
    return tstate, tm, jstate, jm, jgrad, plan


def test_train_step_matches_reference_leaf_by_leaf(stepped):
    """Every leaf of the state after one step (params, master, mu, nu, their
    WO/OO host and device parts as the reference splits them) and the grad
    norm.  Adam's first step moves each weight by lr g / (|g| + eps): where
    the reference's gradient is within the gradient tolerance (1e-4 of the
    tensor's largest) of zero the packages may round it to either sign, and
    the update to anything in [-lr, lr]; elsewhere the params and master
    agree within lr / 2, and on average within 1e-6 everywhere."""
    tstate, tm, jstate, jm, jgrad, _ = stepped
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert int(tstate["step"]) == int(jstate["step"]) == 1
    lr = TOPT.AdamConfig().lr
    split = 0
    for e in ("params", "master", "mu", "nu"):
        for n, jl in jstate[e].items():
            tl = tstate[e][n]
            g = jgrad[n]
            resolved = np.abs(g) > 1e-4 * np.abs(g).max()
            assert JOPT.is_split(jl) == TOPT.is_split(tl), (e, n)
            if TOPT.is_split(tl):
                k = tl["host"].shape[0]
                pairs = [(tl["host"], jl["host"], resolved[:k]),
                         (tl["dev"], jl["dev"], resolved[k:])]
            else:
                pairs = [(tl, jl, resolved)]
            split += TOPT.is_split(tl)
            for got, want, sure in pairs:
                assert tuple(got.shape) == tuple(want.shape), (e, n)
                if e in ("params", "master"):
                    err = np.abs(_np(got) - _np(want))
                    assert err.mean() <= 1e-6 and err.max() <= 2 * lr, \
                        (e, n, err.max(), err.mean())
                    assert not sure.any() or err[sure].max() <= lr / 2, \
                        (e, n, err[sure].max())
                else:
                    _close_scaled(got, want, 1e-4, f"{e}/{n}")
    # every stacked leaf (9 names of the Mamba stack and groups/in_proj) is
    # split in master, mu and nu
    assert split == 3 * (1 + len([n for n in jstate["params"]
                                  if n.startswith("mamba/")]))


def test_train_state_crosses_the_bridge_and_the_loop(stepped, tmp_path):
    """The zamba2 state after a step through ``bridge`` both ways bit for
    bit; and a ``TrainLoop`` of two bf16 steps at WO = OO = 0.5 checkpoints
    its state, which ``TrainLoop.resume`` writes into a fresh state bit for
    bit, in place (one device)."""
    tstate, *_, plan = stepped
    ref = bridge.train_state_to_numpy(tstate)
    back = bridge.train_state_to_numpy(bridge.train_state_from_numpy(
        ref, param_dtype=torch.float32))
    for e in ("params", "master", "mu", "nu"):
        assert set(back[e]) == set(ref[e])
        for n, v in ref[e].items():
            if isinstance(v, dict):
                for part in ("host", "dev"):
                    np.testing.assert_array_equal(back[e][n][part], v[part])
            else:
                np.testing.assert_array_equal(back[e][n], v)

    model = build_model(TCFG, "cpu")
    step = make_train_step(model, plan)
    data = SyntheticLM(BatchSpec(2, S, TCFG.vocab_size))

    def fresh(seed):
        return init_train_state(model, plan,
                                torch.Generator().manual_seed(seed))

    loop = TrainLoop(step.fn, fresh(0),
                     lambda i: {k: torch.from_numpy(v)
                                for k, v in data.batch(i).items()},
                     ckpt_dir=tmp_path, cfg=LoopConfig(total_steps=2,
                                                       ckpt_every=2))
    stats = loop.run()
    assert stats.steps_done == 2 and Checkpointer(tmp_path).all_steps() == [2]
    live = fresh(1)
    host = live["master"]["mamba/mixer/in_proj"]["host"]
    at, got, _ = TrainLoop.resume(tmp_path, StatePlacement(TCFG, plan, None,
                                                           "cpu"), into=live)
    assert at == 2 and got is live
    assert got["master"]["mamba/mixer/in_proj"]["host"] is host
    want, flat = _flatten(loop.state), _flatten(got)
    assert flat.keys() == want.keys()
    for k, v in want.items():
        assert flat[k].dtype == v.dtype, k
        assert torch.equal(_bits(flat[k]), _bits(v)), k


def test_init_train_state_splits_the_hybrid_as_the_reference(weights):
    """WO/OO host splits of the 2-D stacked Mamba leaves (by groups), the
    groups' in-proj and the unsplit shared block: every leaf's (host,
    device) shapes are the reference's ``init_state``'s."""
    model = build_model(TCFG, "cpu")
    jplan = jax_plan(JCFG.num_layers, **_plan())
    plan = Plan.from_json(jplan.to_json())
    tstate = init_train_state(model, plan, torch.Generator().manual_seed(0))
    _, axes = JHY.init_hybrid(jax.random.PRNGKey(0), JCFG, abstract=True)
    jstate = JOPT.init_state({n: jax.ShapeDtypeStruct(v.shape, jnp.bfloat16)
                              for n, v in weights.items()}, axes,
                             jplan.stages[0])
    for e in ("master", "mu", "nu"):
        for n, jl in jstate[e].items():
            tl = tstate[e][n]
            if JOPT.is_split(jl):
                assert TOPT.is_split(tl), (e, n)
                assert (tuple(tl["host"].shape), tuple(tl["dev"].shape)) == \
                    (jl["host"].shape, jl["dev"].shape), (e, n)
            else:
                assert tuple(tl.shape) == jl.shape, (e, n)


def test_multi_device_hybrid_training_raises():
    """What has no reference or is not ported raises and names it: the
    multi-device step's lowering of a hybrid plan of two stages (the
    reference pipelines no hybrid), and a Mamba2 mixer's decode on a tp
    rank of a multi-device plan (multi-device serving)."""
    from repro_torch.models import ssm as TSSM
    from repro_torch.models.common import Parallel
    from repro_torch.training import step as TSTEP
    model = build_model(TCFG, "cpu")
    one = Plan.from_json(jax_plan(JCFG.num_layers, **_plan()).to_json())
    st = one.stages[0].replace(layers=JCFG.num_layers // 2)
    with pytest.raises(NotImplementedError, match="PIPELINE_FAMILIES"):
        TSTEP._lowered(model, one.replace(stages=(st, st)), None)
    par = Parallel(None, None, 1, 2, 0, 0, sp=False)
    with pytest.raises(NotImplementedError, match="multi-device serving"):
        TSSM.mamba2_mixer({}, torch.zeros(1, 1, TCFG.d_model), TCFG,
                          ExecConfig(par=par), cache={})
