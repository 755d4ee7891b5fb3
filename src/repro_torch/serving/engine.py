"""Continuous-batching serve engine over a paged KV cache (the port of
``repro/serving/engine.py``).

``ContinuousBatchingEngine`` turns the one-shot ``generate()`` path into
a per-step admit/decode/retire loop: requests of mixed prompt/output
lengths share a fixed pool of decode slots and KV pages, new requests
are prefilled (batch 1) and paged in the moment a slot and pages free
up, and finished requests release both at once.

Token identity with the contiguous path is the load-bearing contract:
admission runs the REAL prefill (never prefill-as-decode), page-in
copies the exact prefill rows, and the paged decode step
(``training.step.make_paged_serve_step``) rebuilds bitwise the
contiguous cache before every token -- so each request's greedy tokens
equal a batch-1 ``launch.serve.generate()`` at the same ``max_len``,
token for token (tests/test_torch_serving_engine.py, ``serve
--continuous`` and chip_smoke.py's phase S).

The engine runs on ``model.device``, on one device or, with ``mesh``, on a
rank of a dp = 1 plan at any tp whose cache tp splits on the kv heads or
not at all: every tp rank runs the same schedule and block table (the
argmax of the logits gathered whole is the same on each), and each
rank's pools hold its kv heads, so ``memory_bytes()`` is
``concrete_paged_cache_bytes`` at (dp = 1, tp).  dp > 1, or a cache whose
KV sequence a group splits, raises (``make_paged_serve_step``).  The
block table lives on the host and is uploaded when it changes; the greedy
argmax runs on the device and is read to the host once a step.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.pages import (PagedKvAllocator, classify_cache_tree,
                                       data_pages, init_paged_state,
                                       pages_for, paged_state_bytes,
                                       tree_get)
from repro_torch.serving.scheduler import ContinuousScheduler, ServeRequest


class ContinuousBatchingEngine:
    """Drive the paged decode step under the continuous scheduler.

    ``slots`` decode rows ride every step, ``max_len`` is the global
    decode horizon (every request's rows + max_new must fit it), and
    ``page_size`` (``plan.page_size`` when tuned) carves each slot's KV
    into ``max_len / page_size`` pages.  ``watermark`` reserves free
    pages at admission so in-flight decodes can extend without instant
    preemption (default: one page per slot, clamped to the pool).
    """

    @torch.inference_mode()
    def __init__(self, model, params, plan, *, slots: int, max_len: int,
                 page_size: int, watermark: Optional[int] = None,
                 max_admits_per_step: int = 1, mesh=None):
        from repro_torch.training.step import (make_paged_serve_step,
                                               make_prefill_step)
        self.model, self.params, self.plan = model, params, plan
        self.device = model.device
        self.slots, self.max_len = int(slots), int(max_len)
        self.page_size = int(page_size)
        self.kv8 = plan.kv_cache_dtype == "int8"
        cache_dtype = torch.int8 if self.kv8 else torch.bfloat16

        self.specs = classify_cache_tree(model.cfg, self.slots, self.max_len,
                                         plan.kv_cache_dtype)
        self.npp = self.max_len // self.page_size
        self.n_data_pages = data_pages(self.slots, self.max_len,
                                       self.page_size)
        self.trash_page = self.n_data_pages
        wm = (min(self.slots, self.n_data_pages - 1) if watermark is None
              else watermark)
        self.allocator = PagedKvAllocator(num_pages=self.n_data_pages,
                                          page_size=self.page_size,
                                          watermark=wm)
        self.sched = ContinuousScheduler(
            slots=self.slots, allocator=self.allocator,
            max_admits_per_step=max_admits_per_step)

        # the paged step first: it refuses the layouts the engine cannot
        # page (dp > 1, a split KV sequence) before anything is allocated
        self._step = make_paged_serve_step(
            model, plan, slots=self.slots, max_len=self.max_len,
            page_size=self.page_size, mesh=mesh)
        args = (model, self.specs, self.slots, self.max_len, self.page_size,
                cache_dtype)
        self.state, bt = init_paged_state(*args) if mesh is None else \
            init_paged_state(*args, shard=self._step.rank.local_shape)
        self.block_table = bt.numpy()     # mutable host copy; (slots, npp)
        self._bt_dev: Optional[torch.Tensor] = None
        self._prefill = make_prefill_step(model, plan, return_cache=True,
                                          mesh=mesh, batch=1)
        self._tokens = np.zeros((self.slots, 1), np.int32)
        self.results: Dict[Any, List[int]] = {}
        self.steps_run = 0
        self.admissions = 0               # prefills run (replays included)
        self._rid_seq = 0

    # -- public API -----------------------------------------------------------

    def submit(self, prompt: Dict[str, Any], max_new: int,
               rid: Any = None) -> Any:
        """Queue one request; returns its id."""
        if rid is None:
            rid = self._rid_seq
            self._rid_seq += 1
        self.sched.submit(ServeRequest(rid=rid, prompt=prompt,
                                       max_new=int(max_new)))
        return rid

    @torch.inference_mode()
    def run(self) -> Dict[Any, np.ndarray]:
        """Drive the loop until every submitted request retires; returns
        {rid: generated token ids} (length max_new each)."""
        while self.sched.has_work():
            admitted = self._admission_pass()
            self._coverage_pass()
            if not self.sched.active:
                if self.sched.waiting and not admitted:
                    head = self.sched.waiting[0]
                    raise RuntimeError(
                        f"request {head.rid!r} cannot be admitted with an "
                        f"idle engine: pool of {self.n_data_pages} pages x "
                        f"{self.page_size} rows (watermark "
                        f"{self.allocator.watermark}) is too small")
                continue   # everything retired at admission (max_new == 1)
            self._decode_step()
        return {rid: np.asarray(toks, np.int32)
                for rid, toks in self.results.items()}

    def memory_bytes(self) -> int:
        """Exact bytes of the engine's cache state (pools + slot tree +
        int32 block table) -- compared bitwise against
        ``concrete_paged_cache_bytes`` at (dp = 1, tp)."""
        return paged_state_bytes(self.state, self.block_table)

    # -- scheduling passes ----------------------------------------------------

    def _admission_pass(self) -> int:
        admitted = 0
        while (admitted < self.sched.max_admits_per_step
               and self.sched.can_try_admit()):
            req = self.sched.waiting[0]
            if req.prefilled is None:
                req.prefilled = self._run_prefill(req)
            first_tok, caches, rows = req.prefilled
            if rows + req.max_new > self.max_len:
                raise ValueError(
                    f"request {req.rid!r}: {rows} prompt rows + "
                    f"{req.max_new} new tokens exceed max_len "
                    f"{self.max_len}")
            if self.sched.peak_pages(rows, req.max_new) > self.n_data_pages:
                raise ValueError(
                    f"request {req.rid!r} needs more pages than the "
                    f"whole pool at page_size {self.page_size}")
            # the watermark reserve only makes sense with decodes in
            # flight; an idle engine admits on raw free pages
            idle = not self.sched.active and not admitted
            if not self.allocator.can_admit(rows + 1,
                                            ignore_watermark=idle):
                break                      # pages below watermark: wait
            slot = self.sched.admit(req, rows, ignore_watermark=idle)
            req.prefilled = None           # drop the stashed cache tree
            self.results[req.rid] = []     # preemption replay starts over
            self._install(slot, req.rid, caches, rows)
            self._record_token(slot, first_tok)
            admitted += 1
        return admitted

    def _coverage_pass(self) -> None:
        for slot in self.sched.active_slots():
            if slot not in self.sched.active:
                continue                   # preempted below us this pass
            while True:
                got = self.sched.ensure_coverage(slot)
                if got is not None:
                    if got:
                        self._sync_block_row(slot)
                    break
                victim = self.sched.preempt_youngest()
                self._clear_slot(victim)
                if victim == slot:
                    break                  # we were the youngest: requeued

    def _decode_step(self) -> None:
        if self._bt_dev is None:              # uploaded when it changed
            self._bt_dev = torch.from_numpy(self.block_table).to(self.device)
        tokens = torch.from_numpy(self._tokens).to(self.device)
        logits, self.state = self._step.fn(self.params, tokens, self.state,
                                           self._bt_dev)
        # greedy argmax on the device -- the op the static path runs --
        # read to the host once a step
        toks = logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()
        self.steps_run += 1
        for slot in self.sched.active_slots():
            st = self.sched.active[slot]
            st.pos += 1                    # mirrors the in-step pos + 1
            self._record_token(slot, int(toks[slot]))

    # -- device-state plumbing ------------------------------------------------

    def _run_prefill(self, req: ServeRequest):
        """Batch-1 prefill (+ int8 quantization under int8 plans); returns
        (first greedy token, cache tree, cache rows)."""
        from repro_torch.models.zoo import quantize_caches
        logits, caches = self._prefill.fn(self.params, req.prompt)
        if self.kv8:
            caches = quantize_caches(caches)
        self.admissions += 1
        first = int(logits[0, -1].argmax())
        sp = next(sp for sp in self.specs if sp.paged)
        rows = int(tree_get(caches, sp.path).shape[sp.bdim + 1])
        return first, caches, rows

    def _install(self, slot: int, rid, caches, rows: int) -> None:
        """Page the prefill's KV into the owned pages and copy the
        slot-resident state (+ per-request pos) into decode row ``slot``."""
        pages = self.allocator.pages(rid)
        for sp in self.specs:
            leaf, pleaf = tree_get(self.state, sp.path), \
                tree_get(caches, sp.path)
            if sp.paged:
                self._page_in(leaf, pleaf, pages, rows)
            elif sp.is_pos:
                leaf[..., slot] = rows
            elif sp.bdim is not None:
                leaf.select(sp.bdim, slot).copy_(pleaf.select(sp.bdim, 0))
        self._sync_block_row(slot)

    def _page_in(self, pool, pleaf, pages, rows: int) -> None:
        """Copy the prefill's ``rows`` rows into the request's pages (the
        last page's tail zero); the pool never aliases the prefill's
        tensors."""
        ps = self.page_size
        n_used = pages_for(rows, ps)
        if n_used == 0:
            return
        lead, tail = pool.shape[0], tuple(pool.shape[3:])
        x = pleaf[:, 0].to(pool.dtype)               # (lead, rows, *tail)
        pad = n_used * ps - rows
        if pad:
            x = torch.cat([x, x.new_zeros((lead, pad) + tail)], dim=1)
        ids = torch.tensor(pages[:n_used], dtype=torch.long,
                           device=pool.device)
        pool[:, ids] = x.reshape((lead, n_used, ps) + tail)

    def _sync_block_row(self, slot: int) -> None:
        st = self.sched.active[slot]
        pages = self.allocator.pages(st.rid)
        self.block_table[slot] = self.trash_page
        self.block_table[slot, :len(pages)] = pages
        self._bt_dev = None

    def _clear_slot(self, slot: int) -> None:
        """Neutralize a freed slot: all-trash block table (its in-step
        writes land on the trash page), pos = 0 (its gathered rows mask
        to zero), token 0."""
        self.block_table[slot] = self.trash_page
        self._bt_dev = None
        self._tokens[slot] = 0
        for sp in self.specs:
            if sp.is_pos:
                tree_get(self.state, sp.path)[..., slot] = 0

    def _record_token(self, slot: int, tok: int) -> None:
        st = self.sched.active[slot]
        self.results[st.rid].append(tok)
        st.emitted += 1
        self._tokens[slot] = tok
        if st.emitted >= st.max_new:
            self.sched.retire(slot)
            self._clear_slot(slot)
