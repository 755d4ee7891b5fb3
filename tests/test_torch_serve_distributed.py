"""Multi-device serving of the PyTorch port on the CPU, over gloo, at the
reduced granite-3-8b and qwen2-72b (4 layers, d 128, 4 heads of 32 over
one KV head; qwen2-72b with QKV biases) and qwen2-moe-a2.7b (4 heads over 4
KV heads, QKV biases, 4 experts top-2), in f32, from one init: every rank
cuts the one-process params (``bridge.shard_params``; the QKV biases set
to random values, so that they count).  A batch of 2 prompts of 12 tokens
(3 for the ``_b3`` case) is prefilled and decoded 6 steps at max_len 18.

Each plan is held to one process (``mesh=None``): the prefill's logits
and every decode step's, gathered over the data ranks, within 1e-5, and
the tokens equal, ``generate(mesh=)``'s too; each rank's cache bytes equal
``concrete_cache_bytes`` at the plan's (dp, tp), bitwise.  The layouts
(``sharding.cache_specs``): at tp 2 and 4 granite's and qwen2-72b's one KV
head is held whole by every tp rank (at dp 1 the reference's chain puts
``data`` on the sequence, so tp does not take it), qwen2-moe's KV heads
split over tp; at dp 2 x tp 2 with the batch of 2, granite's and
qwen2-72b's KV sequence splits over tp (the flash-decoding merge over the
model group, in bf16 and int8); at dp 2 with the batch of 3, which dp does
not divide, the KV sequence splits over dp (every data rank decodes all
three rows and merges over the data group); dp 2 at ZeRO 3 gathers each
layer's weights.  The merge sums in another order than one device's
softmax: 1e-5, not bitwise.

The ranks of each world size (2 and 4) are processes started together, as
``torchrun`` starts them, beside one jax subprocess that runs the
reference's ``generate`` on a 1 x 4 and a 2 x 2 mesh of forced host
devices (qwen2-72b at tp 4, granite at dp 2 x tp 2) from the same params:
its tokens equal the port's, its logits within 1e-5 at every step.  The
continuous-batching engine runs qwen2-moe at tp 2 (its KV heads split),
token for token with the static decode under the same mesh, its bytes
``concrete_paged_cache_bytes`` at (1, 2).  The refusals (the engine at dp
2, the engine on a sequence-split cache, zamba2 under tp) raise and name
ROADMAP.md.  ``cache_specs`` equals the reference's specs and the memory
model's cache layout for every registered arch at (dp, tp) in {1, 2, 4}^2.
"""
import itertools
import json
import math
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.core.plan import single_stage_plan
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import init_distributed, make_plan_mesh
from repro_torch.lowering import plan_mesh_axes
from repro_torch.lowering.cache_layout import (concrete_cache_bytes,
                                               concrete_paged_cache_bytes)
from repro_torch.models.zoo import build_model, pad_caches, quantize_caches
from repro_torch.parallel import sharding as SH
from repro_torch.training import step as TSTEP

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = {"granite": "granite-3-8b", "qwen72": "qwen2-72b",
         "moe": "qwen2-moe-a2.7b"}
PLEN, GEN = 12, 6
MAX_LEN = PLEN + GEN
TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (model, dp, tp, zero, batch, kv cache dtype)
CASES = {
    "granite_tp2": ("granite", 1, 2, 0, 2, "bf16"),
    "qwen72_tp2": ("qwen72", 1, 2, 0, 2, "bf16"),
    "moe_tp2": ("moe", 1, 2, 0, 2, "bf16"),
    "granite_dp2": ("granite", 2, 1, 0, 2, "bf16"),
    "granite_dp2_b3": ("granite", 2, 1, 0, 3, "bf16"),
    "qwen72_dp2_z3": ("qwen72", 2, 1, 3, 2, "bf16"),
    "moe_dp2_z3": ("moe", 2, 1, 3, 2, "bf16"),
    "granite_tp4": ("granite", 1, 4, 0, 2, "bf16"),
    "qwen72_tp4": ("qwen72", 1, 4, 0, 2, "bf16"),
    "moe_tp4": ("moe", 1, 4, 0, 2, "bf16"),
    "granite_dp2_tp2": ("granite", 2, 2, 0, 2, "bf16"),
    "granite_dp2_tp2_int8": ("granite", 2, 2, 0, 2, "int8"),
    "qwen72_dp2_tp2": ("qwen72", 2, 2, 0, 2, "bf16"),
    "moe_dp2_tp2": ("moe", 2, 2, 0, 2, "bf16"),
}
# the cases whose KV sequence a group splits: case -> the group's axis
SEQ_SPLIT = {"granite_dp2_b3": "data", "granite_dp2_tp2": "model",
             "granite_dp2_tp2_int8": "model", "qwen72_dp2_tp2": "model"}
# the reference's meshes: case -> its (dp, tp)
REFERENCE_CASES = ("qwen72_tp4", "granite_dp2_tp2")
# the engine: qwen2-moe at tp 2, three requests over two slots
ENGINE_PLENS, ENGINE_GENS, ENGINE_SLOTS, ENGINE_PAGE = (5, 9, 12), \
    (6, 3, 6), 2, 6


def _plan(name):
    arch, dp, tp, zero, _, kv = CASES[name]
    cfg = get_arch(ARCHS[arch]).reduced()
    return cfg, single_stage_plan(cfg.num_layers, dp=dp, tp=tp,
                                  micro_batch=1, grad_accum=1, zero=zero,
                                  ckpt_layers=0, kv_cache_dtype=kv)


def _params(cfg):
    """The one-process f32 params of seed 0, as numpy, with random QKV
    biases."""
    params, _ = build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0), torch.float32)
    flat = bridge.params_to_numpy(params)
    rng = np.random.default_rng(1)
    for n in ("bq", "bk", "bv"):
        key = f"layers/attn/{n}"
        if key in flat:
            flat[key] = rng.normal(0, 0.1, flat[key].shape).astype(
                np.float32)
    return flat


def _prompts(cfg, batch, plen=PLEN, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, plen)).astype(np.int32))


def _f32_serving():
    """The serve exec config computing in f32 (its default is bf16)."""
    orig = TSTEP.serve_exec_cfg
    TSTEP.serve_exec_cfg = lambda *a, **k: orig(*a, **k).replace(
        compute_dtype=torch.float32)
    return orig


def _decode(model, params, plan, prompts, mesh=None):
    """generate()'s steps with the logits kept: (every step's logits
    gathered over the data ranks, the tokens, this rank's cache bytes)."""
    b = prompts.shape[0]
    prefill = TSTEP.make_prefill_step(model, plan, return_cache=True,
                                      mesh=mesh, batch=b)
    serve = TSTEP.make_serve_step(model, plan, batch=b, max_len=MAX_LEN,
                                  mesh=mesh)
    with torch.inference_mode():
        logits, caches = prefill.fn(params, {"tokens": prompts})
        if plan.kv_cache_dtype == "int8":
            caches = quantize_caches(caches)
        caches = serve.place(pad_caches(caches, MAX_LEN - PLEN))
        # at the plan's cache dtype: this test computes in f32, so a bf16
        # plan's k and v are held in f32
        nbytes = sum(x.numel() * (2 if x.dtype == torch.float32 and
                                  k in ("k", "v") else x.element_size())
                     for k, x in caches.items())
        seen = [serve.gather_rows(logits[:, -1])]
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks = [tok]
        for _ in range(GEN - 1):
            logits, caches = serve.fn(params, tok, caches)
            seen.append(serve.gather_rows(logits[:, -1]))
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            toks.append(tok)
    return (torch.stack(seen).numpy(),
            serve.gather_rows(torch.cat(toks, 1)).numpy(), nbytes)


def _raises(fn) -> str:
    """The message of the NotImplementedError ``fn`` raises ('' if none)."""
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return ""


def _refusals(world):
    """The engine at dp 2, the engine where the KV sequence is split (dp 2
    x tp 2, its slots split over dp and the one KV head's sequence over
    tp), zamba2 under tp."""
    from repro_torch.serving import ContinuousBatchingEngine
    out = {}
    cfg = get_arch(ARCHS["granite"]).reduced()
    model = build_model(cfg, "cpu")
    if world == 2:
        plan = single_stage_plan(cfg.num_layers, dp=2, tp=1, micro_batch=1,
                                 grad_accum=1)
        mesh = make_plan_mesh(2, 1, "cpu")
        out["engine_dp2"] = _raises(lambda: ContinuousBatchingEngine(
            model, None, plan, slots=2, max_len=MAX_LEN, page_size=6,
            mesh=mesh))
        zcfg = get_arch("zamba2-2.7b").reduced()
        zplan = single_stage_plan(zcfg.num_layers, dp=1, tp=2, micro_batch=1,
                                  grad_accum=1)
        out["zamba2_tp2"] = _raises(lambda: TSTEP.make_serve_step(
            build_model(zcfg, "cpu"), zplan, batch=2, max_len=MAX_LEN,
            mesh=make_plan_mesh(1, 2, "cpu")))
    else:
        plan = single_stage_plan(cfg.num_layers, dp=2, tp=2, micro_batch=1,
                                 grad_accum=1)
        out["engine_seq_split"] = _raises(lambda: ContinuousBatchingEngine(
            model, None, plan, slots=2, max_len=MAX_LEN, page_size=6,
            mesh=make_plan_mesh(2, 2, "cpu")))
    return out


def _engine(mesh):
    """qwen2-moe at tp 2 in bf16 through the engine, and each request's
    batch-1 static decode under the same mesh."""
    name = "moe_tp2"
    cfg, plan = _plan(name)
    plan = plan.replace(attn_impl="pallas", use_pallas=True)
    model = build_model(cfg, "cpu")
    params = bridge.shard_params(_params(cfg), cfg, plan, mesh,
                                 dtype=torch.bfloat16)
    prompts = [_prompts(cfg, 1, n, seed=10 + i)
               for i, n in enumerate(ENGINE_PLENS)]
    from repro_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, params, plan, slots=ENGINE_SLOTS,
                                   max_len=MAX_LEN, page_size=ENGINE_PAGE,
                                   mesh=mesh)
    for i, (p, g) in enumerate(zip(prompts, ENGINE_GENS)):
        eng.submit({"tokens": p}, g, rid=i)
    res = eng.run()
    static = [serve_launch.generate(model, params, p, g, plan,
                                    max_len=MAX_LEN, mesh=mesh)[0].numpy()
              for p, g in zip(prompts, ENGINE_GENS)]
    return dict(engine=[res[i] for i in range(len(prompts))], static=static,
                bytes=eng.memory_bytes(), steps=eng.steps_run)


def _rank_main(out: str) -> None:
    """One rank of a world: every case of its size, the engine and the
    refusals; rank 0 pickles the results."""
    rank, world, _ = init_distributed("cpu")
    bf16 = _f32_serving()
    results = {}
    try:
        for name, (arch, dp, tp, _, batch, _) in CASES.items():
            if dp * tp != world:
                continue
            cfg, plan = _plan(name)
            mesh = make_plan_mesh(dp, tp, "cpu")
            model = build_model(cfg, "cpu")
            flat = _params(cfg)
            params = bridge.shard_params(flat, cfg, plan, mesh,
                                         dtype=torch.float32)
            drawn, _ = TSTEP.init_rank_params(
                model, plan, mesh, torch.Generator().manual_seed(0),
                torch.float32)
            init_ok = all(torch.equal(drawn[n], params[n]) for n in drawn
                          if not n.endswith(("bq", "bk", "bv")))
            prompts = _prompts(cfg, batch)
            logits, toks, nbytes = _decode(model, params, plan, prompts,
                                           mesh)
            gen = serve_launch.generate(model, params, prompts, GEN, plan,
                                        max_len=MAX_LEN, mesh=mesh).numpy()
            every = [None] * world
            dist.all_gather_object(every, (nbytes, init_ok))
            ec = TSTEP.serve_rank(model, plan, mesh, batch, MAX_LEN).ec
            if rank == 0:
                split = ec.kv_split.axis if ec.kv_split is not None else None
                results[name] = dict(logits=logits, tokens=toks,
                                     generate=gen, rank_bytes=every,
                                     split=(split, ec.cache_update))
        if world == 2:
            TSTEP.serve_exec_cfg = bf16          # the engine runs in bf16
            eng = _engine(make_plan_mesh(1, 2, "cpu"))
            if rank == 0:
                results["engine"] = eng
        refused = _refusals(world)
        if rank == 0:
            results[f"refusals@{world}"] = refused
    finally:
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()


def _start_world(world: int, out: pathlib.Path):
    port = train_launch._free_port()
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT / 'tests')!r}]; "
            "import test_torch_serve_distributed as T; "
            f"T._rank_main({str(out)!r})")
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


REFERENCE_SERVE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs.base import get_arch
from repro.core.plan import Plan
from repro.lowering import lower_plan
from repro.models.zoo import build_model, pad_caches
from repro.training.step import make_prefill_step, make_serve_step


class F32:
    # the reference's lowering with its serve exec config in f32
    def __init__(self, low):
        self._low = low

    def __getattr__(self, name):
        return getattr(self._low, name)

    @property
    def serve_exec_cfg(self):
        return self._low.serve_exec_cfg.replace(compute_dtype=jnp.float32)


with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
out = {}
for name, c in inp.items():
    cfg = get_arch(c["arch"]).reduced()
    plan = Plan.from_json(c["plan"])
    st = plan.stages[0]
    mesh = compat.make_mesh((st.dp, st.tp), ("data", "model"))
    with compat.set_mesh(mesh):
        # launch/serve.py's generate, with the padded caches placed by the
        # serve step's cache shardings (this jax refuses a jit argument
        # whose sharding differs from in_shardings)
        low = F32(lower_plan(cfg, None, plan, mesh))
        model = build_model(cfg)
        params = {n: jnp.asarray(v) for n, v in c["params"].items()}
        prompts = jnp.asarray(c["prompts"])
        b, plen = prompts.shape
        logits, caches = make_prefill_step(
            model, return_cache=True, lowered=low).fn(
                params, {"tokens": prompts})
        caches = pad_caches(caches, c["max_len"] - plen)
        serve = make_serve_step(model, batch=b, max_len=c["max_len"],
                                donate=False, lowered=low)
        caches = jax.device_put(caches, serve.batch_shardings)
        seen, toks = [], []
        for _ in range(c["gen"]):
            seen.append(np.asarray(logits[:, -1]))
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(
                jnp.int32)[:, None]
            toks.append(np.asarray(tok))
            if len(toks) < c["gen"]:
                logits, caches = serve.fn(params, tok, caches)
    out[name] = {"logits": np.stack(seen),
                 "tokens": np.concatenate(toks, 1)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _start_reference(tmp: pathlib.Path):
    inp = {}
    for name in REFERENCE_CASES:
        cfg, plan = _plan(name)
        inp[name] = dict(arch=ARCHS[CASES[name][0]], plan=plan.to_json(),
                         params=_params(cfg), gen=GEN, max_len=MAX_LEN,
                         prompts=_prompts(cfg, CASES[name][4]).numpy())
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SERVE, str(tmp / "ref_in.pkl"),
         str(tmp / "ref_out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _collect(procs, what):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    assert all(p.returncode == 0 for p in procs), \
        what + "\n" + "\n".join(logs)[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank 0's results of every case (both world sizes started at once)
    and the reference's meshes, started beside them."""
    tmp = tmp_path_factory.mktemp("serve_dist")
    worlds = {w: _start_world(w, tmp / f"ws{w}.pkl") for w in (2, 4)}
    ref = _start_reference(tmp)
    results = {}
    for w, procs in worlds.items():
        _collect(procs, f"world of {w}")
        with open(tmp / f"ws{w}.pkl", "rb") as f:
            results.update(pickle.load(f))
    _collect([ref], "the reference's meshes")
    with open(tmp / "ref_out.pkl", "rb") as f:
        results["reference"] = pickle.load(f)
    return results


@pytest.fixture(scope="module")
def one_process():
    """case -> the one-process run of its model, batch and cache dtype."""
    orig = _f32_serving()
    try:
        out = {}
        for name in CASES:
            cfg, plan = _plan(name)
            one = plan.replace(stages=(plan.stages[0].replace(dp=1, tp=1,
                                                              zero=0),))
            params = bridge.params_from_numpy(_params(cfg),
                                              dtype=torch.float32)
            out[name] = _decode(build_model(cfg, "cpu"), params, one,
                                _prompts(cfg, CASES[name][4]))
        return out
    finally:
        TSTEP.serve_exec_cfg = orig


@pytest.mark.parametrize("case", list(CASES))
def test_rank_decode_matches_one_process(runs, one_process, case):
    """Prefill and decode logits within 1e-5, tokens equal (also
    ``generate(mesh=)``'s), every rank's cache bytes the memory model's,
    ``init_rank_params`` the cut of the one-process init, and the
    sequence split and cache-update mode the layout gives."""
    arch, dp, tp, _, batch, kv = CASES[case]
    got = runs[case]
    want_logits, want_toks, _ = one_process[case]
    np.testing.assert_allclose(got["logits"], want_logits, **TOL)
    np.testing.assert_array_equal(got["tokens"], want_toks)
    np.testing.assert_array_equal(got["generate"], want_toks)
    cfg, _ = _plan(case)
    want = concrete_cache_bytes(cfg, batch, MAX_LEN, kv, dp_size=dp,
                                tp_size=tp)
    assert [b for b, _ in got["rank_bytes"]] == [want] * (dp * tp)
    assert all(ok for _, ok in got["rank_bytes"])
    # the owner-only write only where a group splits the KV sequence
    axis = SEQ_SPLIT.get(case)
    assert got["split"] == (axis, "dus" if axis is None else "onehot")


def test_reference_meshes_generate_the_same_tokens(runs):
    """The reference's ``generate`` on a 1 x 4 mesh (qwen2-72b at tp 4)
    and a 2 x 2 mesh (granite at dp 2 x tp 2, its KV sequence split over
    tp in the port): tokens equal, the prefill's and every decode step's
    logits within 1e-5."""
    for case in REFERENCE_CASES:
        ref, got = runs["reference"][case], runs[case]
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        np.testing.assert_allclose(got["logits"], ref["logits"], **TOL)


def test_engine_at_tp2_matches_the_static_decode(runs):
    """qwen2-moe at tp 2 (2 KV heads a rank): every request's tokens equal
    its batch-1 static decode under the same mesh; the rank's pools are
    ``concrete_paged_cache_bytes`` at (dp 1, tp 2)."""
    eng = runs["engine"]
    for got, want in zip(eng["engine"], eng["static"]):
        np.testing.assert_array_equal(got, want)
    cfg = get_arch(ARCHS["moe"]).reduced()
    assert eng["bytes"] == concrete_paged_cache_bytes(
        cfg, ENGINE_SLOTS, MAX_LEN, ENGINE_PAGE, "bf16", dp_size=1,
        tp_size=2)
    assert eng["steps"] > 0


def test_refusals_name_the_roadmap(runs):
    """The engine at dp 2, the engine on a sequence-split cache, and
    zamba2 under tp each raise and name ROADMAP.md."""
    refused = {**runs["refusals@2"], **runs["refusals@4"]}
    assert set(refused) == {"engine_dp2", "engine_seq_split", "zamba2_tp2"}
    for what, msg in refused.items():
        assert "ROADMAP.md" in msg, (what, msg)
    assert "dp 2" in refused["engine_dp2"]
    assert "split" in refused["engine_seq_split"]


def _flat(tree, pre=()):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, pre + (k,)) if isinstance(v, dict)
                   else {pre + (k,): v})
    return out


def _live(spec, sizes):
    """A reference spec in the port's form: axes of size 1 dropped."""
    out = []
    for e in spec:
        names = () if e is None else e if isinstance(e, tuple) else (e,)
        live = tuple(n for n in names if sizes[n] > 1)
        out.append(None if not live else live[0] if len(live) == 1
                   else live)
    return tuple(out)


def _heads_read_what_the_cache_holds():
    """For every (heads, kv heads, tp) with tp dividing the heads: where tp
    divides the kv heads, a rank's query heads read exactly the kv heads
    ``cache_specs`` gives its cache (part r of the kv-head dim) and wk
    holds; where it does not (granite's 8 over tp 16: two ranks read one),
    they read within ``layers._kv_range``, of the cache's every head."""
    from types import SimpleNamespace
    from repro_torch.models.layers import _kv_range
    for h, kv in itertools.product((4, 8, 16, 32, 64), (1, 2, 4, 8, 16)):
        if h % kv:
            continue
        cfg = get_arch(ARCHS["granite"]).replace(num_heads=h,
                                                 num_kv_heads=kv)
        for tp in (2, 4, 8, 16):
            if h % tp:
                continue
            split = kv % tp == 0
            mesh = SH.abstract_mesh((1, tp), ("data", "model"))
            spec = SH.cache_specs({"k": torch.empty((2, 3, 6, kv, 8),
                                                    device="meta")},
                                  mesh, plan_mesh_axes(mesh, tp), 3)["k"]
            assert (spec[3] == "model") is split, (h, kv, tp)
            h_loc, g = h // tp, h // kv
            for r in range(tp):
                p = {"wq": torch.empty((8, h_loc, 8), device="meta"),
                     "wk": torch.empty((8, kv // tp if split else kv, 8),
                                       device="meta")}
                read = {i // g for i in range(r * h_loc, (r + 1) * h_loc)}
                rows = _kv_range(p, cfg, SimpleNamespace(tp_rank=r))
                if split:
                    assert rows is None, (h, kv, tp)
                    assert read == set(range(r * kv // tp,
                                             (r + 1) * kv // tp))
                else:
                    assert read <= set(range(*rows)), (h, kv, tp, r)


def test_cache_specs_match_the_reference_and_the_memory_model():
    """Every registered arch (reduced), batch 1-4, bf16 and int8, at (dp,
    tp) in {1, 2, 4}^2: ``cache_specs`` equals the reference's specs leaf
    for leaf, ``cache_update_mode`` the reference's mode, and the bytes
    the specs leave a rank equal ``concrete_cache_bytes``
    (``lowering/cache_layout.py``); and a rank's query heads read
    the kv heads its cache holds (``_heads_read_what_the_cache_holds``)."""
    _heads_read_what_the_cache_holds()
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.configs.base import get_arch as jax_arch
    from repro.lowering.lower import plan_mesh_axes as jax_axes
    from repro.models.zoo import build_model as jax_build
    from repro.parallel import sharding as JSH
    for arch in list_archs():
        cfg = get_arch(arch).reduced()
        jmodel = jax_build(jax_arch(arch).reduced())
        model = build_model(cfg, "meta")
        for batch, kv in itertools.product((1, 2, 3, 4), ("bf16", "int8")):
            jdt = jnp.int8 if kv == "int8" else jnp.bfloat16
            tdt = torch.int8 if kv == "int8" else torch.bfloat16
            jc = jax.eval_shape(lambda: jmodel.init_caches(batch, 16, jdt))
            tc = model.init_caches(batch, 16, tdt)
            for dp, tp in itertools.product((1, 2, 4), repeat=2):
                sizes = {"data": dp, "model": tp}
                jmesh = compat.abstract_mesh((dp, tp), ("data", "model"))
                jma = jax_axes(jmesh, tp)
                js = JSH.cache_specs(jc, jmesh, jma, batch)
                want = {tuple(p.key for p in path): _live(s.spec, sizes)
                        for path, s in jax.tree_util.tree_leaves_with_path(
                            js, is_leaf=lambda x: hasattr(x, "spec"))}
                mesh = SH.abstract_mesh((dp, tp), ("data", "model"))
                ma = plan_mesh_axes(mesh, tp)
                specs = SH.cache_specs(tc, mesh, ma, batch)
                got = _flat(specs)
                what = (arch, batch, kv, dp, tp)
                assert got == want, what
                assert SH.cache_update_mode(specs, ma) == \
                    JSH.cache_update_mode(js, jma), what
                held = sum(math.prod(x.shape) * x.element_size()
                           / math.prod(sizes[e] for e in got[p] if e)
                           for p, x in _flat(tc).items())
                assert held == concrete_cache_bytes(
                    cfg, batch, 16, kv, dp_size=dp, tp_size=tp), what


def test_launcher_serves_the_tuned_plan_on_four_ranks(capfd):
    """``serve --arch qwen2-72b --smoke --tune --nproc 4 --device cpu``
    serves on the tuner's plan for 4 devices: the predicted-versus-report
    line bitwise, and rank 0 prints the tokens of all 4 rows."""
    rc = serve_launch.main(["--arch", "qwen2-72b", "--smoke", "--tune",
                            "--nproc", "4", "--device", "cpu"])
    out = capfd.readouterr().out
    assert rc == 0, out
    assert "(bitwise=True)" in out
    line = next(x for x in out.splitlines()
                if x.startswith("# tokens gathered from the ranks: "))
    toks = np.asarray(json.loads(line.split(": ", 1)[1]))
    assert toks.shape == (4, 16)
