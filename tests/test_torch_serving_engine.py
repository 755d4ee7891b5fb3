"""The continuous-batching engine of the PyTorch port (``repro_torch.serving``)
on the CPU, against its own static decode and against the JAX reference's
engine, at reduced configs (granite-3-8b, zamba2-2.7b, qwen2-moe-a2.7b).

1. **Allocator and scheduler**: the reference's cases and hypothesis
   invariants on the port's copies, and a differential run -- the same
   random traffic through both packages' allocators gives the same page
   ids, free counts and high-water marks.
2. **Token identity**: each request's greedy tokens equal the batch-1
   static decode (``launch.serve.generate``) at the engine's ``max_len``,
   bitwise, in bf16 for the three families and in int8 for granite and
   zamba2 (the reference's parameters: slots 2, page 8, prompts (6, 10),
   budgets (6, 3), max_len 32); ``memory_bytes()`` equals
   ``concrete_paged_cache_bytes`` bitwise.
3. **Against the reference's engine**: the same f32 weights (crossed with
   ``bridge``) and requests through both engines, both computing in f32:
   equal ``steps_run``, the same block table before every step, and the
   same tokens.  qwen2-moe also runs at slots 6, where an expert
   overflows its capacity (asserted): the port drops what the reference
   drops.
4. **One paged step** against the reference's ``make_paged_serve_step`` on
   the same pools, block table, positions and tokens: logits and the
   written rows at 1e-4 in f32 and 3e-2 in bf16, every other row of every
   pool bitwise unchanged, the inactive slot's row on the trash page.
5. **Recycled pages** read as zeros at and past a request's position, and
   **NaN planted** in an inactive slot's state and in every free page
   leaves the active requests' tokens unchanged.
6. **Classification**: the port's paged-leaf choices equal the
   reference's ``classify_cache_tree``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import compat
from repro.configs.base import get_arch as jax_get_arch
from repro.core.plan import single_stage_plan as jax_plan
from repro.launch.mesh import make_host_mesh
from repro.lowering import lower_plan
from repro.models import decoder as JDEC
from repro.models import hybrid as JHY
from repro.models.zoo import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import PagedKvAllocator as JAllocator
from repro.serving import engine as JENG
from repro.serving.pages import classify_cache_tree as jax_classify
from repro.training.step import make_paged_serve_step as jax_paged_step
from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.core.plan import single_stage_plan
from repro_torch.launch.serve import generate
from repro_torch.lowering.cache_layout import concrete_paged_cache_bytes
from repro_torch.models import moe as TMOE
from repro_torch.models.zoo import build_model
from repro_torch.serving import (ContinuousBatchingEngine,
                                 ContinuousScheduler, PagedKvAllocator,
                                 ServeRequest, pages_for)
from repro_torch.serving import engine as TENG
from repro_torch.serving.pages import (classify_cache_tree, init_paged_state,
                                       tree_get, tree_paths)
from repro_torch.training import step as TSTEP

ARCHS = {"gqa": "granite-3-8b", "hybrid": "zamba2-2.7b",
         "moe": "qwen2-moe-a2.7b"}
SLOTS, PAGE, MAX_LEN = 2, 8, 32
PLENS, GENS = (6, 10), (6, 3)


# -- 1. allocator and scheduler ---------------------------------------------------


class TestAllocator:
    def test_lowest_id_first_and_release_returns_all(self):
        a = PagedKvAllocator(num_pages=6, page_size=4)
        assert a.admit("r0", rows=9) == [0, 1, 2]     # ceil(9/4)
        assert a.admit("r1", rows=1) == [3]
        assert a.used == 4 and a.free == 2
        assert a.extend("r0", rows=13) == [4]
        assert a.extend("r0", rows=13) == []          # already covered
        assert a.extend("r1", rows=24) is None        # 6 - 2 free < 5
        assert sorted(a.release("r0")) == [0, 1, 2, 4]
        assert a.used == 1 and a.free == 5
        assert a.highwater == 5

    def test_watermark_gates_admission_only(self):
        a = PagedKvAllocator(num_pages=4, page_size=2, watermark=2)
        assert a.can_admit(4)                          # leaves 2 free
        assert not a.can_admit(6)                      # would leave 1
        assert a.can_admit(6, ignore_watermark=True)
        a.admit("r0", rows=4)
        # extension may dip below the watermark freely
        assert a.extend("r0", rows=8) == [2, 3]
        with pytest.raises(RuntimeError):
            a.admit("r1", rows=1)

    def test_double_admit_rejected(self):
        a = PagedKvAllocator(num_pages=2, page_size=2)
        a.admit("r0", rows=1)
        with pytest.raises(ValueError):
            a.admit("r0", rows=1)

    @given(st.data())
    @settings(max_examples=60, deadline=None)
    def test_invariants_under_random_traffic(self, data):
        num_pages = data.draw(st.integers(1, 24), label="num_pages")
        page_size = data.draw(st.integers(1, 8), label="page_size")
        a = PagedKvAllocator(num_pages=num_pages, page_size=page_size)
        covered = {}                    # rid -> rows granted so far
        next_rid = 0
        max_rows = num_pages * page_size
        for _ in range(data.draw(st.integers(1, 40), label="steps")):
            ops = ["admit"] + (["extend", "release"] if covered else [])
            op = data.draw(st.sampled_from(ops), label="op")
            if op == "admit":
                rows = data.draw(st.integers(1, max_rows), label="rows")
                if a.can_admit(rows):
                    pages = a.admit(next_rid, rows)
                    assert len(pages) == pages_for(rows, page_size)
                    covered[next_rid] = rows
                    next_rid += 1
                else:
                    with pytest.raises(RuntimeError):
                        a.admit(next_rid, rows)
            elif op == "extend":
                rid = data.draw(st.sampled_from(sorted(covered)),
                                label="rid")
                rows = data.draw(st.integers(1, max_rows), label="rows")
                need = pages_for(rows, page_size) - len(a.pages(rid))
                free_before = a.free
                got = a.extend(rid, rows)
                if got is None:                    # pool exhausted
                    assert need > free_before
                else:
                    assert len(got) == max(0, need)
                    covered[rid] = max(covered[rid], rows)
            else:
                rid = data.draw(st.sampled_from(sorted(covered)),
                                label="rid")
                freed = a.release(rid)
                assert len(freed) == pages_for(covered.pop(rid), page_size)
            # global invariants, every step
            assert a.used + a.free == num_pages
            owned = [p for rid in a.owners() for p in a.pages(rid)]
            assert len(owned) == len(set(owned))       # no aliasing
            assert len(owned) == a.used
            for rid in a.owners():
                assert len(a.pages(rid)) == pages_for(covered[rid],
                                                      page_size)
        for rid in list(a.owners()):
            a.release(rid)
        assert a.free == num_pages                 # everything freed

    @given(st.data())
    @settings(max_examples=60, deadline=None)
    def test_matches_reference_allocator_under_random_traffic(self, data):
        """The same ops through both packages' allocators: the same page
        ids, refusals, free counts and high-water marks at every step."""
        num_pages = data.draw(st.integers(1, 24), label="num_pages")
        page_size = data.draw(st.integers(1, 8), label="page_size")
        wm = data.draw(st.integers(0, num_pages - 1), label="watermark")
        kw = dict(num_pages=num_pages, page_size=page_size, watermark=wm)
        a, r = PagedKvAllocator(**kw), JAllocator(**kw)
        max_rows = num_pages * page_size + 2
        live, next_rid = [], 0

        def both(fn):
            out = []
            for alloc in (a, r):
                try:
                    out.append(("ok", fn(alloc)))
                except (RuntimeError, ValueError) as e:
                    out.append((type(e).__name__, None))
            assert out[0] == out[1]
            return out[0]

        for _ in range(data.draw(st.integers(1, 40), label="steps")):
            ops = ["admit"] + (["extend", "release"] if live else [])
            op = data.draw(st.sampled_from(ops), label="op")
            rows = data.draw(st.integers(0, max_rows), label="rows")
            if op == "admit":
                ign = data.draw(st.booleans(), label="ignore_watermark")
                assert a.can_admit(rows, ign) == r.can_admit(rows, ign)
                if both(lambda x: x.admit(next_rid, rows, ign))[0] == "ok":
                    live.append(next_rid)
                next_rid += 1
            else:
                rid = data.draw(st.sampled_from(live), label="rid")
                if op == "extend":
                    both(lambda x: x.extend(rid, rows))
                else:
                    both(lambda x: x.release(rid))
                    live.remove(rid)
            assert (a.free, a.used, a.highwater, a.owners()) == \
                (r.free, r.used, r.highwater, r.owners())
            assert all(a.pages(i) == r.pages(i) for i in live)


class TestScheduler:
    def test_preempt_youngest_requeues_at_head(self):
        alloc = PagedKvAllocator(num_pages=4, page_size=4)
        sched = ContinuousScheduler(slots=2, allocator=alloc)
        a, b = ServeRequest("a", {}, 8), ServeRequest("b", {}, 8)
        sched.submit(a)
        sched.submit(b)
        sa = sched.admit(a, rows=7)                    # 2 pages
        sb = sched.admit(b, rows=7)                    # 2 pages: pool full
        b.prefilled = ("tok", "caches", 7)
        sched.active[sa].pos = 8      # next step writes row 8: third page
        assert sched.ensure_coverage(sa) is None       # exhausted
        victim = sched.preempt_youngest()
        assert victim == sb
        assert sched.waiting[0] is b                   # requeued at HEAD
        assert b.prefilled is None                     # full replay
        assert alloc.free == 2
        assert sched.ensure_coverage(sa) == [2]        # now succeeds

    def test_retire_frees_slot_and_pages(self):
        alloc = PagedKvAllocator(num_pages=4, page_size=4)
        sched = ContinuousScheduler(slots=1, allocator=alloc)
        r = ServeRequest("r", {}, 2)
        sched.submit(r)
        slot = sched.admit(r, rows=3)
        assert not sched.can_try_admit()               # no free slot
        sched.retire(slot)
        assert alloc.free == 4 and not sched.active

    def test_peak_pages_covers_admission_and_tail(self):
        alloc = PagedKvAllocator(num_pages=8, page_size=4)
        sched = ContinuousScheduler(slots=1, allocator=alloc)
        assert sched.peak_pages(rows=3, max_new=1) == 1    # admit: rows+1
        assert sched.peak_pages(rows=3, max_new=14) == 4   # tail: rows+13


# -- helpers ------------------------------------------------------------------


def _plan(cfg, kv="bf16", mod=single_stage_plan):
    return mod(cfg.num_layers, dp=1, tp=1, micro_batch=1, grad_accum=1,
               zero=0, ckpt_layers=0, kv_cache_dtype=kv, page_size=PAGE)


def _prompts(cfg, plens=PLENS, seed=100):
    return [np.random.default_rng(seed + i).integers(
        0, cfg.vocab_size, (1, n), dtype=np.int32)
        for i, n in enumerate(plens)]


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    """The reduced config, its model on the CPU and bf16 params (made
    once; no test writes to them)."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, "cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


def _engine_run(model, params, plan, prompts, gens, slots=SLOTS,
                max_len=MAX_LEN, before_step=None, **kw):
    eng = ContinuousBatchingEngine(model, params, plan, slots=slots,
                                   max_len=max_len, page_size=PAGE, **kw)
    if before_step is not None:
        step = eng._step.fn

        def hooked(p, tokens, state, bt):
            before_step(eng, state, bt)
            return step(p, tokens, state, bt)
        eng._step.fn = hooked
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit({"tokens": torch.from_numpy(p)}, g, rid=i)
    return eng.run(), eng


def _static(model, params, plan, prompt, gen, max_len=MAX_LEN):
    return generate(model, params, torch.from_numpy(prompt), gen, plan,
                    max_len=max_len)[0].numpy()


# -- 2. token identity and the bytes -------------------------------------------------


@pytest.mark.parametrize("fam,kv", [("gqa", "bf16"), ("hybrid", "bf16"),
                                    ("moe", "bf16"), ("gqa", "int8"),
                                    ("hybrid", "int8")])
def test_paged_decode_token_identical(fam, kv):
    cfg, model, params = _port_model(ARCHS[fam])
    plan = _plan(cfg, kv)
    prompts = _prompts(cfg)
    res, eng = _engine_run(model, params, plan, prompts, GENS)
    for i, (p, g) in enumerate(zip(prompts, GENS)):
        ref = _static(model, params, plan, p, g)
        assert np.array_equal(res[i], ref), \
            f"{fam}/{kv}: request {i} diverged: {res[i]} != {ref}"
    want = int(concrete_paged_cache_bytes(cfg, SLOTS, MAX_LEN, PAGE, kv,
                                          dp_size=1, tp_size=1))
    assert eng.memory_bytes() == want
    assert eng.admissions == len(prompts) and eng.steps_run > 0
    pools = {sp.key: tree_get(eng.state, sp.path).dtype
             for sp in eng.specs if sp.paged}
    code = torch.int8 if kv == "int8" else torch.bfloat16
    assert pools == dict(k=code, v=code, **(
        dict(k_scale=torch.float32, v_scale=torch.float32)
        if kv == "int8" else {}))


# -- 3. against the reference's engine -------------------------------------------------


class _F32Lowered:
    """The reference's lowered plan with its serve exec config computing in
    f32 (its engine reads ``serve_exec_cfg`` from the lowering)."""

    def __init__(self, low):
        self._low = low

    def __getattr__(self, name):
        return getattr(self._low, name)

    @property
    def serve_exec_cfg(self):
        return self._low.serve_exec_cfg.replace(compute_dtype=jnp.float32)


@pytest.fixture
def both_f32(monkeypatch):
    """Both engines in f32: the port's serve steps computing in f32 (the
    serve exec config's compute dtype is bf16 in both packages; the
    reference's side is ``_F32Lowered``) and both engines' caches in f32
    (their bf16 default would round k/v and, in the port, meet f32 weights
    in bf16)."""
    orig = TSTEP.serve_exec_cfg
    monkeypatch.setattr(TSTEP, "serve_exec_cfg", lambda plan: orig(
        plan).replace(compute_dtype=torch.float32))
    def in_f32(init, f32):      # (init_caches or model, specs, slots,
        return lambda *a: init(*a[:5], f32)  # max_len, page, dtype)
    for mod, f32 in ((TENG, torch.float32), (JENG, jnp.float32)):
        monkeypatch.setattr(mod, "init_paged_state",
                            in_f32(mod.init_paged_state, f32))


@functools.lru_cache(maxsize=None)
def _f32_weights(arch):
    jcfg = jax_get_arch(arch).reduced()
    init = JHY.init_hybrid if jcfg.family == "hybrid" else JDEC.init_lm
    jparams, _ = init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    flat = {n: np.asarray(v) for n, v in jparams.items()}
    return jcfg, jparams, bridge.params_from_numpy(flat,
                                                   dtype=torch.float32)


def _record_tables(eng):
    seen = []
    orig = eng._decode_step

    def hooked():
        seen.append(np.array(eng.block_table))
        orig()
    eng._decode_step = hooked
    return seen


@pytest.mark.parametrize("fam,slots,n_req", [
    ("gqa", SLOTS, 2), ("hybrid", SLOTS, 2), ("moe", SLOTS, 2),
    ("moe", 6, 8)], ids=["gqa", "hybrid", "moe", "moe-slots6"])
def test_engine_matches_reference_engine(fam, slots, n_req, both_f32,
                                         monkeypatch):
    arch = ARCHS[fam]
    jcfg, jparams, tparams = _f32_weights(arch)
    tcfg = get_arch(arch).reduced()
    plens = (PLENS * 4)[:n_req]
    gens = (GENS * 4)[:n_req]
    prompts = _prompts(tcfg, plens)

    mesh = make_host_mesh(1, 1)
    jplan = _plan(jcfg, mod=jax_plan)
    low = _F32Lowered(lower_plan(jcfg, None, jplan, mesh))
    with compat.set_mesh(mesh):
        jeng = JEngine(jax_build_model(jcfg), jparams, jplan, mesh,
                       slots=slots, max_len=MAX_LEN, page_size=PAGE,
                       lowered=low)
        jtables = _record_tables(jeng)
        for i, (p, g) in enumerate(zip(prompts, gens)):
            jeng.submit({"tokens": jnp.asarray(p)}, g, rid=i)
        want = jeng.run()

    dropped = []
    route = TMOE.route

    def counting(logits, cfg, ec):
        r = route(logits, cfg, ec)
        if logits.shape[1] == 1:                     # decode steps only
            dropped.append(int((~r.keep).sum()))
        return r
    monkeypatch.setattr(TMOE, "route", counting)
    teng = ContinuousBatchingEngine(build_model(tcfg, "cpu"), tparams,
                                    _plan(tcfg), slots=slots,
                                    max_len=MAX_LEN, page_size=PAGE)
    ttables = _record_tables(teng)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        teng.submit({"tokens": torch.from_numpy(p)}, g, rid=i)
    got = teng.run()

    assert teng.steps_run == jeng.steps_run
    assert len(ttables) == len(jtables)
    for t, j in zip(ttables, jtables):
        np.testing.assert_array_equal(t, j)
    assert sorted(got) == sorted(want) == list(range(n_req))
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"request {rid}")
    if slots > 4 and fam == "moe":
        assert sum(dropped) > 0, "no expert overflowed: the case is moot"


# -- 4. one paged step against the reference's ---------------------------------------


def _to_jax(t):
    """A copy (the port's step writes its state in place)."""
    a = np.array(t.float() if t.dtype == torch.bfloat16 else t)
    return jnp.asarray(a).astype(jnp.bfloat16) \
        if t.dtype == torch.bfloat16 else jnp.asarray(a)


def _filled_state(model, specs, slots, seed, dtype):
    """The engine's state (its caches in ``dtype``) with every pool (trash
    page included) and every slot-resident leaf filled with random values;
    the caller sets pos."""
    state, bt = init_paged_state(model, specs, slots, MAX_LEN, PAGE, dtype)
    rng = np.random.default_rng(seed)
    for sp in specs:
        leaf = tree_get(state, sp.path)
        if not sp.is_pos:
            leaf.copy_(torch.from_numpy(rng.standard_normal(
                tuple(leaf.shape)).astype(np.float32)))
    return state, bt


@pytest.mark.parametrize("fam,jdtype", [
    ("gqa", jnp.float32), ("gqa", jnp.bfloat16), ("hybrid", jnp.float32),
    ("moe", jnp.float32)], ids=["gqa-f32", "gqa-bf16", "hybrid-f32",
                                "moe-f32"])
def test_one_paged_step_matches_reference(fam, jdtype, monkeypatch):
    arch = ARCHS[fam]
    jcfg, jparams32, tparams32 = _f32_weights(arch)
    tcfg = get_arch(arch).reduced()
    f32 = jdtype == jnp.float32
    tol = 1e-4 if f32 else 3e-2
    if f32:
        orig = TSTEP.serve_exec_cfg
        monkeypatch.setattr(TSTEP, "serve_exec_cfg", lambda plan: orig(
            plan).replace(compute_dtype=torch.float32))
        jparams, tparams = jparams32, tparams32
    else:
        jparams = {n: v.astype(jnp.bfloat16) for n, v in jparams32.items()}
        tparams = {n: v.bfloat16() for n, v in tparams32.items()}
    slots, npp = 3, MAX_LEN // PAGE
    model = build_model(tcfg, "cpu")
    specs = classify_cache_tree(tcfg, slots, MAX_LEN)
    state, bt = _filled_state(model, specs, slots, 5,
                              torch.float32 if f32 else torch.bfloat16)
    trash = slots * npp
    # slot 0 at row 5 of its first page (id 4), slot 1 at row 12 across
    # pages 7 and 2, slot 2 inactive: pos 0 and an all-trash row
    pos = torch.tensor([5, 12, 0], dtype=torch.int32)
    bt[0, :1] = torch.tensor([4])
    bt[1, :2] = torch.tensor([7, 2])
    for sp in specs:
        if sp.is_pos:
            tree_get(state, sp.path).copy_(pos.expand(sp.shape + (slots,)))
    tokens = torch.tensor([[3], [17], [0]], dtype=torch.int32)
    before = {p: tree_get(state, p).clone() for p in tree_paths(state)}

    jstate = _tree_map(state, _to_jax)
    mesh = make_host_mesh(1, 1)
    jplan = _plan(jcfg, mod=jax_plan)
    low = lower_plan(jcfg, None, jplan, mesh)
    low = _F32Lowered(low) if f32 else low
    with compat.set_mesh(mesh):
        jstep = jax_paged_step(jax_build_model(jcfg), slots=slots,
                               max_len=MAX_LEN, page_size=PAGE,
                               donate=False, lowered=low)
        jlogits, jnew = jax.block_until_ready(jstep.fn(
            jparams, jnp.asarray(tokens.numpy()), jstate,
            jnp.asarray(bt.numpy())))

    step = TSTEP.make_paged_serve_step(model, _plan(tcfg), slots=slots,
                                       max_len=MAX_LEN, page_size=PAGE)
    tlogits, tnew = step.fn(tparams, tokens, state, bt)
    np.testing.assert_allclose(tlogits[:2].float().numpy(),
                               np.asarray(jlogits[:2], np.float32),
                               atol=tol, rtol=tol)
    written = {}                # pool path -> flat row ids the step wrote
    for b in range(slots):
        page = bt[b, int(pos[b]) // PAGE]
        written.setdefault(b, int(page) * PAGE + int(pos[b]) % PAGE)
    assert written[2] == trash * PAGE                  # inactive: trash
    rows = sorted(set(written.values()))
    for sp in specs:
        got, old = tree_get(tnew, sp.path), before[sp.path]
        want = np.asarray(_tree_get_j(jnew, sp.path).astype(jnp.float32))
        if sp.paged:
            lead, tail = got.shape[0], tuple(got.shape[3:])
            g = got.reshape((lead, -1) + tail)
            o = old.reshape((lead, -1) + tail)
            w = want.reshape((lead, -1) + tail)
            keep = [r for r in range(g.shape[1]) if r not in rows]
            assert torch.equal(g[:, keep], o[:, keep]), sp.path
            active = [written[0], written[1]]
            np.testing.assert_allclose(g[:, active].float().numpy(),
                                       w[:, active], atol=tol, rtol=tol,
                                       err_msg=str(sp.path))
        elif sp.is_pos:
            assert torch.equal(got, old + 1)
        else:             # the slot-resident state of the active slots
            np.testing.assert_allclose(
                got.narrow(sp.bdim, 0, 2).float().numpy(),
                np.take(want, [0, 1], axis=sp.bdim), atol=tol, rtol=tol,
                err_msg=str(sp.path))


def _tree_map(tree, fn):
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _tree_get_j(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# -- 5. recycled pages and NaN isolation ---------------------------------------------


def test_recycled_pages_read_as_zeros_past_the_position():
    """One slot: request 0 writes pages 0-1, retires; request 1 gets the
    same pages back (page 1 by extension, still holding request 0's rows)
    and its gathered rows at and past its position are zero, bitwise."""
    cfg, model, params = _port_model(ARCHS["gqa"])
    plan = _plan(cfg)
    prompts = _prompts(cfg, plens=(10, 6))
    stale = []

    def check(eng, state, bt):
        dense = eng._step.gather(state, bt)
        pos = int(eng._step.positions(state)[0])
        pool = tree_get(state, ("k",))
        rows = pool[:, bt[0].long()].reshape(pool.shape[0], -1,
                                             *pool.shape[3:])
        stale.append(bool(rows[:, pos:].any()))
        for key in ("k", "v"):
            assert not dense[key][:, 0, pos:].any(), (key, pos)
    res, eng = _engine_run(model, params, plan, prompts, (6, 6), slots=1,
                           before_step=check)
    assert any(stale), "no recycled row held data: the case is moot"
    for i, (p, g) in enumerate(zip(prompts, (6, 6))):
        assert np.array_equal(res[i], _static(model, params, plan, p, g))


def test_nan_in_an_inactive_slot_and_free_pages_stays_there():
    """zamba2 at slots 3 with two requests: NaN in every pool page (trash
    included) and in every slot's SSM state and conv window before the
    run.  Installs overwrite the admitted slots' rows and page-in the
    pages' rows; slot 2 decodes NaN all along.  The requests' tokens equal
    the static decode."""
    cfg, model, params = _port_model(ARCHS["hybrid"])
    plan = _plan(cfg)
    prompts = _prompts(cfg)
    eng = ContinuousBatchingEngine(model, params, plan, slots=3,
                                   max_len=MAX_LEN, page_size=PAGE)
    with torch.inference_mode():
        for sp in eng.specs:
            if not sp.is_pos:
                tree_get(eng.state, sp.path).fill_(float("nan"))
    logits = []
    step = eng._step.fn

    def hooked(p, tokens, state, bt):
        out = step(p, tokens, state, bt)
        logits.append(out[0])
        return out
    eng._step.fn = hooked
    for i, (p, g) in enumerate(zip(prompts, GENS)):
        eng.submit({"tokens": torch.from_numpy(p)}, g, rid=i)
    res = eng.run()
    assert all(torch.isnan(lg[2]).all() for lg in logits)   # slot 2: NaN
    for i, (p, g) in enumerate(zip(prompts, GENS)):
        assert np.array_equal(res[i], _static(model, params, plan, p, g))


# -- 6. classification ---------------------------------------------------------------


@pytest.mark.parametrize("fam", sorted(ARCHS))
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_classification_matches_reference(fam, kv):
    tcfg = get_arch(ARCHS[fam]).reduced()
    jcfg = jax_get_arch(ARCHS[fam]).reduced()
    jdt = jnp.int8 if kv == "int8" else jnp.bfloat16
    want = jax_classify(jax_build_model(jcfg).init_caches, SLOTS, MAX_LEN,
                        jdt)
    got = classify_cache_tree(tcfg, SLOTS, MAX_LEN, kv)
    assert [(s.key, s.shape, s.paged, s.is_pos, s.bdim) for s in got] == \
        [(s.key, s.shape, s.paged, s.is_pos, s.bdim) for s in want]
    assert any(s.paged for s in got)


def test_hybrid_decode_gated_norm_runs_the_rmsnorm_op(monkeypatch):
    """The Mamba2 decode's gated norm goes through ``ops.rmsnorm``: on the
    card the RMSNorm kernel, which computes a row alike at any batch, where
    torch's mean over d_inner sums it in another order at batch 4 than at
    batch 1 (``tools/decode_rows_by_m.py``).  Prefill and training keep
    ``_gated_norm``.  Its value is ``test_torch_hybrid.py``'s to hold."""
    from repro_torch.models import ssm as TSSM
    from repro_torch.models.common import ExecConfig, layer, subtree
    cfg, model, params = _port_model(ARCHS["hybrid"])
    calls = []
    orig = TSSM.kops.rmsnorm

    def counted(x, scale, **kw):
        calls.append(tuple(x.shape))
        return orig(x, scale, **kw)
    monkeypatch.setattr(TSSM.kops, "rmsnorm", counted)
    lp = subtree(layer(layer(subtree(params, "mamba"), 0), 0), "mixer")
    x = torch.randn(3, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).bfloat16()
    caches = model.init_caches(3, MAX_LEN)["mamba"]
    with torch.inference_mode():
        cache = {k: v[0, 0] for k, v in caches.items()}
        TSSM.mamba2_mixer(lp, x, cfg, ExecConfig(), cache=cache)
        assert calls == [(3, 1, TSSM.d_inner(cfg))]
        TSSM.mamba2_mixer(lp, torch.randn(1, 16, cfg.d_model).bfloat16(),
                          cfg, ExecConfig(ssd_chunk=16))
    assert len(calls) == 1
