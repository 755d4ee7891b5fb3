"""Paged KV-cache allocation (the port of ``repro/serving/pages.py``).

Two halves:

* ``PagedKvAllocator`` -- pure-python page accounting over ONE shared
  pool id space: a free list, per-request block lists, a watermark
  admission gate, and a high-water mark.  Invariants (property-tested in
  tests/test_torch_serving_engine.py):

    - a page is owned by at most one live request (no aliasing);
    - ``release``/preemption returns every owned page to the free list;
    - ``used + free == total`` at every point;
    - a request's page count is exactly ``ceil(covered_rows / page_size)``.

* cache-tree classification and pool construction -- the bridge between
  the cache tree ``model.init_caches`` allocates and the paged engine's
  state.  A leaf is PAGED iff it is a KV-sequence leaf whose sequence
  extent is the decode horizon: ``lowering/cache_layout.py``'s probe on
  the meta device (batch and max_len perturbed separately, so a stacked
  lead dim that equals the batch size is never taken for it) and its
  ``is_paged_leaf``, the same predicate the memory model prices.  Paged
  leaves ``(lead, B, S, *tail)`` become pools ``(lead, B·npp + 1,
  page_size, *tail)`` whose last page is a shared TRASH page (inactive
  slots' writes land there); ``pos`` leaves widen to per-request vectors
  (``shape + (B,)``); everything else (the Mamba2 conv window and SSM
  state) stays slot-resident at batch = slots.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch


def pages_for(rows: int, page_size: int) -> int:
    """Pages needed to cover ``rows`` cache rows."""
    if rows <= 0:
        return 0
    return -(-rows // page_size)


class PagedKvAllocator:
    """Fixed-size page-pool accounting with watermark admission.

    ``num_pages`` counts DATA pages only (the engine's shared trash page
    is outside this id space).  Pages are handed out lowest-id-first so
    traces replay deterministically.
    """

    def __init__(self, *, num_pages: int, page_size: int,
                 watermark: int = 0):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        if watermark < 0 or watermark >= num_pages:
            raise ValueError(f"watermark {watermark} must be in "
                             f"[0, num_pages)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.watermark = int(watermark)
        self._free: List[int] = list(range(num_pages))  # ascending
        self._owned: Dict[Any, List[int]] = {}
        self.highwater = 0  # max pages ever simultaneously owned

    # -- accounting ----------------------------------------------------------

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.num_pages - len(self._free)

    def pages(self, rid) -> Tuple[int, ...]:
        return tuple(self._owned[rid])

    def owners(self) -> Tuple[Any, ...]:
        return tuple(self._owned)

    # -- admission / growth / release ---------------------------------------

    def can_admit(self, rows: int, ignore_watermark: bool = False) -> bool:
        """Admission gate: granting ``rows`` of coverage must leave at
        least ``watermark`` pages free (headroom for in-flight decodes
        to extend without immediate preemption).  ``ignore_watermark``
        drops the reserve to zero -- the engine uses it when it is
        otherwise idle, where holding a request back can only deadlock."""
        floor = 0 if ignore_watermark else self.watermark
        return self.free - pages_for(rows, self.page_size) >= floor

    def admit(self, rid, rows: int,
              ignore_watermark: bool = False) -> List[int]:
        """Allocate coverage for ``rows`` to a new request.  The caller
        must gate on :meth:`can_admit`; admitting past the watermark is
        a bug, not a preemption trigger."""
        if rid in self._owned:
            raise ValueError(f"request {rid!r} already admitted")
        if not self.can_admit(rows, ignore_watermark):
            raise RuntimeError(f"admit({rid!r}, rows={rows}) below "
                               f"watermark {self.watermark}")
        n = pages_for(rows, self.page_size)
        got = [self._free.pop(0) for _ in range(n)]
        self._owned[rid] = got
        self.highwater = max(self.highwater, self.used)
        return list(got)

    def extend(self, rid, rows: int) -> Optional[List[int]]:
        """Grow ``rid``'s coverage to ``rows`` total.  Extension may dip
        below the watermark (the watermark gates ADMISSION only); returns
        the newly granted page ids, or None when the pool is exhausted --
        the caller preempts and retries."""
        owned = self._owned[rid]
        need = pages_for(rows, self.page_size) - len(owned)
        if need <= 0:
            return []
        if need > self.free:
            return None
        got = [self._free.pop(0) for _ in range(need)]
        owned.extend(got)
        self.highwater = max(self.highwater, self.used)
        return list(got)

    def release(self, rid) -> List[int]:
        """Retire or preempt: every owned page returns to the free list."""
        pages = self._owned.pop(rid)
        self._free.extend(pages)
        self._free.sort()
        return list(pages)


# ---------------------------------------------------------------------------
# Cache-tree classification and paged engine state
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeafSpec:
    """How one cache leaf maps into the paged engine state."""
    path: Tuple[str, ...]          # keys from the root of the cache tree
    shape: Tuple[int, ...]         # dense shape at (slots, max_len)
    paged: bool                    # carved into a page pool
    is_pos: bool                   # widened to a per-request vector
    bdim: Optional[int]            # batch dim (probe-established)

    @property
    def key(self) -> str:
        return self.path[-1]


def tree_paths(tree: Dict, prefix: Tuple[str, ...] = ()) -> List[Tuple]:
    """Key paths of a nested dict's leaves in the layout's order (dict keys
    sorted, depth first: ``cache_layout._tree_leaves``)."""
    out: List[Tuple] = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.extend(tree_paths(tree[k], prefix + (k,)))
        else:
            out.append(prefix + (k,))
    return out


def tree_get(tree: Dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def map_leaves(tree: Dict, specs: List[LeafSpec], fn) -> Dict:
    """A copy of ``tree``'s dicts with the leaf ``x`` at each spec's path
    replaced by ``fn(spec, x)``."""
    def copy(node):
        return {k: copy(v) if isinstance(v, dict) else v
                for k, v in node.items()}
    out = copy(tree)
    for sp in specs:
        tree_set(out, sp.path, fn(sp, tree_get(tree, sp.path)))
    return out


def classify_cache_tree(cfg, slots: int, max_len: int,
                        kv_cache_dtype: str = "bf16") -> List[LeafSpec]:
    """Classify every leaf of ``cfg``'s decode cache tree at (slots,
    max_len), in the layout's leaf order, from ``derive_cache_layout``'s
    probe and ``is_paged_leaf``."""
    from repro_torch.lowering.cache_layout import (derive_cache_layout,
                                                   is_paged_leaf)
    from repro_torch.models.zoo import build_model
    layout = derive_cache_layout(cfg, slots, max_len, kv_cache_dtype)
    cdt = torch.int8 if kv_cache_dtype == "int8" else torch.bfloat16
    paths = tree_paths(build_model(cfg, "meta").init_caches(slots, max_len,
                                                            cdt))
    specs = []
    for path, leaf in zip(paths, layout.leaves, strict=True):
        assert path[-1] == leaf.key, (path, leaf.key)
        paged = is_paged_leaf(leaf, max_len)
        if paged and leaf.pbdim != 1:
            raise NotImplementedError(
                f"paged leaf {leaf.key!r} has batch dim {leaf.pbdim}; the "
                "paged engine expects exactly one stacked lead dim")
        specs.append(LeafSpec(path=path, shape=leaf.shape, paged=paged,
                              is_pos=leaf.key == "pos", bdim=leaf.pbdim))
    return specs


def data_pages(slots: int, max_len: int, page_size: int) -> int:
    """Data pages in every pool: full coverage for every slot.  Page id
    ``data_pages`` (one past the end) is the shared trash page."""
    if max_len % page_size:
        raise ValueError(f"page_size {page_size} must divide max_len "
                         f"{max_len} (dense gathered length must equal "
                         f"the contiguous cache length)")
    return slots * (max_len // page_size)


def init_paged_state(model, specs: List[LeafSpec], slots: int, max_len: int,
                     page_size: int, cache_dtype=torch.bfloat16, shard=None):
    """The engine's state on ``model.device``: the ``init_caches`` tree with
    paged leaves replaced by zeroed pools and ``pos`` leaves widened to
    int32 per-request vectors, and the ``(slots, npp)`` block table, all
    trash.  Non-paged leaves keep their REAL initial values.  ``shard``: a
    tp rank's leaf shapes (``Model.init_caches``); a pool then holds the
    rank's kv heads, split as its contiguous leaf is."""
    state = model.init_caches(slots, max_len, cache_dtype, shard=shard)
    npp = max_len // page_size
    pool_pages = data_pages(slots, max_len, page_size) + 1  # + trash
    for sp in specs:
        leaf = tree_get(state, sp.path)
        if sp.paged:
            lead, tail = leaf.shape[0], tuple(leaf.shape[3:])
            tree_set(state, sp.path, torch.zeros(
                (lead, pool_pages, page_size) + tail, dtype=leaf.dtype,
                device=leaf.device))
        elif sp.is_pos:
            tree_set(state, sp.path, torch.zeros(
                tuple(leaf.shape) + (slots,), dtype=torch.int32,
                device=leaf.device))
        del leaf
    bt = torch.full((slots, npp), pool_pages - 1, dtype=torch.int32)
    return state, bt


def paged_state_bytes(state, block_table) -> int:
    """Exact bytes the engine allocated (pools + slot state + block
    table) -- compared bitwise against ``concrete_paged_cache_bytes`` at
    the engine's (dp = 1, tp)."""
    return int(sum(tree_get(state, p).nbytes for p in tree_paths(state))
               + block_table.nbytes)
