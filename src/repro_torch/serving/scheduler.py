"""Per-decode-step scheduling policy for the continuous-batching engine
(the port of ``repro/serving/scheduler.py``, a copy: pure python).

The scheduler decides WHAT happens each step (admit / extend / preempt /
retire) and the engine applies it to device tensors.  Policy, in the
order the engine runs it every step:

1. **Admit** (FCFS, bounded): while a decode slot is free, the waiting
   queue is non-empty, and the allocator clears its watermark for the
   head request's coverage, admit -- at most ``max_admits_per_step``
   prefills per decode step, so long prompt bursts interleave with
   in-flight decodes instead of stalling them.
2. **Extend**: every active request's page coverage grows to
   ``pos + 1`` before the step (the decode writes row ``pos``).  On
   pool exhaustion the YOUNGEST active request is preempted --
   restart-from-scratch: pages released, slot freed, request requeued
   at the queue head with its progress cleared (greedy decode is
   deterministic, so the replay emits identical tokens).
3. **Retire**: a request that has emitted ``max_new`` tokens releases
   its pages and slot immediately -- no head-of-line blocking on the
   longest request in the batch.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

from repro_torch.serving.pages import PagedKvAllocator, pages_for


@dataclass
class ServeRequest:
    """One generation request.  ``prompt`` is the model's batch-1 prefill
    batch dict ({"tokens": (1, plen)}); the engine learns the cache-row
    count from the prefill output."""
    rid: Any
    prompt: Dict[str, Any]
    max_new: int
    # engine-managed (cleared on preemption)
    prefilled: Optional[tuple] = field(default=None, repr=False)


@dataclass
class SlotState:
    """Engine-side record of one active decode slot."""
    rid: Any
    req: ServeRequest
    pos: int          # cache rows written so far
    emitted: int      # tokens emitted so far (incl. the prefill token)
    max_new: int
    admit_seq: int    # monotone admission stamp (preemption picks max)


class ContinuousScheduler:
    """Slot + queue bookkeeping around a :class:`PagedKvAllocator`."""

    def __init__(self, *, slots: int, allocator: PagedKvAllocator,
                 max_admits_per_step: int = 1):
        if slots <= 0:
            raise ValueError("slots must be positive")
        self.slots = int(slots)
        self.allocator = allocator
        self.max_admits_per_step = int(max_admits_per_step)
        self.waiting: Deque[ServeRequest] = deque()
        self.active: Dict[int, SlotState] = {}      # slot -> state
        self._free_slots: List[int] = list(range(slots))
        self._seq = itertools.count()

    # -- queries --------------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def can_try_admit(self) -> bool:
        return bool(self.waiting and self._free_slots)

    def active_slots(self) -> List[int]:
        return sorted(self.active)

    def youngest_slot(self) -> int:
        return max(self.active, key=lambda s: self.active[s].admit_seq)

    # -- transitions ----------------------------------------------------------

    def submit(self, req: ServeRequest) -> None:
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        self.waiting.append(req)

    def admit(self, req: ServeRequest, rows: int,
              ignore_watermark: bool = False) -> int:
        """Bind the queue head to a free slot with ``rows + 1`` coverage
        (the first decode writes row ``rows``).  Caller gates on
        ``allocator.can_admit(rows + 1)``."""
        if not (self.waiting and self.waiting[0] is req):
            raise ValueError(f"request {req.rid!r} is not the queue head")
        self.waiting.popleft()
        slot = self._free_slots.pop(0)
        self.allocator.admit(req.rid, rows + 1, ignore_watermark)
        self.active[slot] = SlotState(rid=req.rid, req=req, pos=rows,
                                      emitted=0, max_new=req.max_new,
                                      admit_seq=next(self._seq))
        return slot

    def retire(self, slot: int) -> SlotState:
        st = self.active.pop(slot)
        self.allocator.release(st.rid)
        self._free_slots.append(slot)
        self._free_slots.sort()
        return st

    def preempt_youngest(self) -> int:
        """Restart-from-scratch preemption: release the youngest active
        request and requeue it at the HEAD of the waiting queue with
        progress cleared.  Returns the freed slot."""
        slot = self.youngest_slot()
        st = self.active.pop(slot)
        self.allocator.release(st.rid)
        self._free_slots.append(slot)
        self._free_slots.sort()
        st.req.prefilled = None   # drop the stashed prefill: full replay
        self.waiting.appendleft(st.req)
        return slot

    def ensure_coverage(self, slot: int) -> Optional[List[int]]:
        """Grow ``slot``'s pages to cover the row this step writes.
        Returns new page ids ([] if already covered) or None when the
        pool is exhausted -- caller preempts and retries."""
        st = self.active[slot]
        return self.allocator.extend(st.rid, st.pos + 1)

    def peak_pages(self, rows: int, max_new: int) -> int:
        """Worst-case simultaneous pages one request needs: admission
        coverage ``rows + 1`` or final-step coverage ``rows + max_new -
        1``, whichever is larger.  Must fit the pool or the request can
        never complete (checked at admission)."""
        ps = self.allocator.page_size
        return max(pages_for(rows + 1, ps),
                   pages_for(rows + max_new - 1, ps))
