"""Shared KV/state-cache layout: ONE derivation of per-device cache bytes,
evaluated both symbolically (the serve cost model's Expr tapes) and
concretely (``memory_report`` on serve shapes) — the cache-side twin of
:mod:`repro_torch.lowering.state_layout` and the same two-evaluation
contract it holds for training state.

``derive_cache_layout`` walks the cache tree the runtime actually
allocates (``model.init_caches`` on the meta device — the port's
counterpart of the reference's ``jax.eval_shape``; leaves in jax's
tree-leaf order, dict keys sorted) and records each leaf's key, shape,
dtype width, and by-value batch-dim location.  ``cache_bytes``
then reproduces the sharding cascade of
the reference's ``parallel/sharding.py::cache_specs`` leaf by leaf as indicator
arithmetic over a tiny Ops adapter:

* batch divisible by dp (and dp > 1)  ->  batch dim sharded over dp;
* otherwise, KV-sequence leaves shard their sequence dim over dp
  (flash-decoding-style sequence-parallel KV);
* tp lands on the canonical head/state/channel dim when divisible, with
  the same per-key fallback chain ``cache_specs`` implements (k/v fall
  back to the sequence dim only when dp did not take it, scales mirror
  k/v, ...).

Because the indicator cascades are exactly 0.0/1.0 and every quantity is
integer-exact in float64, the symbolic blend equals the concrete select
bitwise.  A copy of ``repro/lowering/cache_layout.py``; only the probe in
``derive_cache_layout`` differs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, TYPE_CHECKING

from repro_torch.lowering.state_layout import (CONCRETE_OPS, SYMBOLIC_OPS)
from repro_torch.core import symbolic as S

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.configs.base import ArchConfig

# Keys whose cache leaf carries the KV sequence at ``bdim + 1`` — the
# reference's ``parallel/sharding.py::_SEQ_LEAF_SEQ_DIM`` keys.
SEQ_CACHE_KEYS = ("k", "v", "latent", "k_rope", "k_scale", "v_scale")

# state-head keys (mamba2 / mLSTM) that shard dim bdim+1 over tp
_STATE_KEYS = ("ssm", "c", "n", "m")


@dataclass(frozen=True)
class CacheLeaf:
    """One abstract cache tensor, as the runtime allocates it."""
    key: str                       # trailing pytree key (cache_specs' view)
    shape: Tuple[int, ...]
    itemsize: int
    bdim: Optional[int]            # batch dim located BY VALUE (or None)
    # probe-established dims (batch / max_len perturbed separately on the
    # meta device) — what the PAGED engine classifies by.  ``bdim`` must
    # stay by-value because it mirrors ``cache_specs``' runtime sharding;
    # the allocator cannot tolerate that hazard, so it gets its own view.
    pbdim: Optional[int] = None    # unique batch-varying dim (or None)
    sdims: Tuple[int, ...] = ()    # max_len-varying dims

    @property
    def nd(self) -> int:
        return len(self.shape)


@dataclass(frozen=True)
class CacheLayout:
    arch: str
    batch: int
    max_len: int
    kv_cache_dtype: str
    leaves: Tuple[CacheLeaf, ...]  # in tree-leaf order (dict keys sorted)


_LAYOUT_CACHE: Dict[Tuple[Any, int, int, str], CacheLayout] = {}


def _tree_leaves(tree: Dict, key: str = "") -> list:
    """(key, leaf) pairs of a nested dict in jax's tree-leaf order: dict
    keys sorted, depth first; ``key`` is the leaf's own (last) key."""
    if not isinstance(tree, dict):
        return [(key, tree)]
    out: list = []
    for k in sorted(tree):
        out.extend(_tree_leaves(tree[k], k))
    return out


def derive_cache_layout(cfg: "ArchConfig", batch: int, max_len: int,
                        kv_cache_dtype: str = "bf16") -> CacheLayout:
    """Allocate the model's decode caches on the meta device and record the
    layout (shapes and dtypes only; nothing is allocated)."""
    key = (cfg, int(batch), int(max_len), kv_cache_dtype)
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit
    import torch
    from repro_torch.models.zoo import build_model

    model = build_model(cfg, "meta")
    cdt = torch.int8 if kv_cache_dtype == "int8" else torch.bfloat16
    caches = _tree_leaves(model.init_caches(batch, max_len, cdt))
    # probe trees: batch and max_len perturbed separately, so a stacked
    # lead dim equal to the batch by value can never be mistaken for it
    bpro = _tree_leaves(model.init_caches(batch + 1, max_len, cdt))
    spro = _tree_leaves(model.init_caches(batch, max_len + 1, cdt))
    leaves = []
    for (k, x), (_, lb), (_, ls) in zip(caches, bpro, spro):
        shape = tuple(int(d) for d in x.shape)
        bdim = next((i for i, d in enumerate(shape) if d == batch), None)
        bdims = [i for i, (a, b) in enumerate(zip(shape, lb.shape))
                 if a != b]
        sdims = tuple(i for i, (a, b) in enumerate(zip(shape, ls.shape))
                      if a != b)
        leaves.append(CacheLeaf(key=k, shape=shape,
                                itemsize=int(x.element_size()),
                                bdim=bdim,
                                pbdim=bdims[0] if len(bdims) == 1 else None,
                                sdims=sdims))
    layout = CacheLayout(arch=cfg.name, batch=int(batch),
                         max_len=int(max_len),
                         kv_cache_dtype=kv_cache_dtype,
                         leaves=tuple(leaves))
    _LAYOUT_CACHE[key] = layout
    return layout


def _leaf_shards(leaf: CacheLeaf, batch: float, dp, tp, sb, ops) -> Any:
    """Device count one cache leaf divides over — the symbolic twin of
    ``_nshards(mesh, cache_specs(...)[leaf])``.

    ``sb`` is the tree-global shard-batch indicator (batch % dp == 0 and
    dp > 1).  Structural facts (key, rank, which dims exist) are concrete
    python at derivation time; only dp/tp (and the divisibilities they
    induce) flow through ``ops``.
    """
    if leaf.bdim is None:
        return 1.0
    nd, bdim, dims = leaf.nd, leaf.bdim, [float(d) for d in leaf.shape]
    seq_elig = leaf.key in SEQ_CACHE_KEYS and nd > bdim + 1

    # dp: batch dim when sb, else the KV sequence dim of eligible leaves
    # (cache_specs assigns dp there unconditionally; at dp == 1 both
    # reads are the identity, so the factor is simply dp).
    dp_f = dp if seq_elig else ops.where(sb, dp, 1.0)

    # tp cascade, per key — each chain reproduces cache_specs' elif
    # order.  At tp == 1 every divisibility holds and the factor is
    # tp == 1.0, matching the gated-off concrete branch exactly.
    tp_f = 1.0
    if leaf.key in ("k", "v"):
        head_ok = (ops.divisible(dims[nd - 2], tp)
                   if nd >= bdim + 3 else 0.0)
        if nd > bdim + 1:
            # sequence dim is free for tp iff dp took the batch dim
            seq_ok = sb * ops.divisible(dims[bdim + 1], tp)
            tp_f = ops.where(head_ok, tp, ops.where(seq_ok, tp, 1.0))
        else:                                        # pragma: no cover
            tp_f = ops.where(head_ok, tp, 1.0)
    elif leaf.key in _STATE_KEYS and nd > bdim + 1:
        tp_f = ops.where(ops.divisible(dims[bdim + 1], tp), tp, 1.0)
    elif leaf.key == "conv":
        tp_f = ops.where(ops.divisible(dims[nd - 1], tp), tp, 1.0)
    elif leaf.key in ("latent", "k_rope") and nd > bdim + 1:
        seq_ok = sb * ops.divisible(dims[bdim + 1], tp)
        tp_f = ops.where(seq_ok, tp, 1.0)
    elif leaf.key in ("k_scale", "v_scale"):
        last_ok = ops.divisible(dims[nd - 1], tp)
        seq_ok = (sb * ops.divisible(dims[bdim + 1], tp)
                  if nd > bdim + 1 else 0.0)
        tp_f = ops.where(last_ok, tp, ops.where(seq_ok, tp, 1.0))
    return dp_f * tp_f


def cache_bytes(layout: CacheLayout, *, dp, tp, ops=SYMBOLIC_OPS) -> Any:
    """Per-device cache bytes of the whole tree: sum over leaves of
    ``numel * itemsize / shards``, accumulated in tree-leaf order (the
    order the concrete report sums in)."""
    batch = float(layout.batch)
    sb = ops.divisible(batch, dp) * ops.gt(dp, 1.0)
    total = 0.0
    for leaf in layout.leaves:
        n = float(math.prod(leaf.shape))
        sh = _leaf_shards(leaf, batch, dp, tp, sb, ops)
        total = total + n * float(leaf.itemsize) / sh
    return total


def is_paged_leaf(leaf: CacheLeaf, max_len: int) -> bool:
    """A leaf the paged engine carves into pages: a KV-sequence leaf whose
    sequence extent IS the decode horizon (probe-established, matching
    the reference's ``serving/pages.py::classify_cache_tree`` exactly).  Enc-dec cross
    k/v (sequence extent = encoder length) and SSM/conv state stay
    slot-resident."""
    return (leaf.key in SEQ_CACHE_KEYS and leaf.pbdim is not None
            and (leaf.pbdim + 1) in leaf.sdims)


def paged_cache_bytes(layout: CacheLayout, *, page_size: int, dp, tp,
                      ops=SYMBOLIC_OPS) -> Any:
    """Per-device bytes of the PAGED serve cache tree — the single
    derivation behind both the symbolic serve cost model and the concrete
    ``memory_report`` on paged shapes (same two-evaluation contract as
    ``cache_bytes``).

    The paged engine replaces every paged leaf (lead, B, S, tail) with a
    page pool (lead, B*npp + 1, page_size, tail) — npp = max_len //
    page_size pages per request plus one shared trash page duplicate
    writes land on — widens each ``pos`` leaf to a per-request vector,
    and always allocates one shared (B, npp) int32 block table (the
    paged step takes it even for pure-state families with no paged
    leaves).  Pools shard exactly like their contiguous counterparts
    (``_leaf_shards`` on the original leaf), so at dp == tp == 1 this is
    byte-exact against the engine's replicated allocation.
    """
    ps = int(page_size)
    if ps <= 0:
        return cache_bytes(layout, dp=dp, tp=tp, ops=ops)
    if layout.max_len % ps:
        raise ValueError(
            f"page_size {ps} must divide max_len {layout.max_len}")
    npp = layout.max_len // ps
    batch = float(layout.batch)
    sb = ops.divisible(batch, dp) * ops.gt(dp, 1.0)
    total = 0.0
    for leaf in layout.leaves:
        sh = _leaf_shards(leaf, batch, dp, tp, sb, ops)
        if is_paged_leaf(leaf, layout.max_len):
            lead = float(math.prod(leaf.shape[:leaf.pbdim]))
            tail = float(math.prod(leaf.shape[leaf.pbdim + 2:]))
            n = lead * (batch * float(npp) + 1.0) * float(ps) * tail
        elif leaf.key == "pos":
            n = float(math.prod(leaf.shape)) * batch  # widened to (.., B)
        else:
            n = float(math.prod(leaf.shape))
        total = total + n * float(leaf.itemsize) / sh
    return total + batch * float(npp) * 4.0  # shared int32 block table


def symbolic_paged_cache_bytes(cfg: "ArchConfig", batch: int, max_len: int,
                               page_size: int,
                               kv_cache_dtype: str = "bf16") -> S.Expr:
    """Serve-cost-model entry point for paged pools, over ``dp``/``tp``."""
    layout = derive_cache_layout(cfg, batch, max_len, kv_cache_dtype)
    return S.wrap(paged_cache_bytes(layout, page_size=page_size,
                                    dp=S.Sym("dp"), tp=S.Sym("tp"),
                                    ops=SYMBOLIC_OPS))


def concrete_paged_cache_bytes(cfg: "ArchConfig", batch: int, max_len: int,
                               page_size: int, kv_cache_dtype: str, *,
                               dp_size: int, tp_size: int) -> float:
    """Lowering entry point for paged pools (memory_report's concrete
    evaluation of the same derivation)."""
    layout = derive_cache_layout(cfg, batch, max_len, kv_cache_dtype)
    return paged_cache_bytes(layout, page_size=page_size, dp=float(dp_size),
                             tp=float(tp_size), ops=CONCRETE_OPS)


def symbolic_cache_bytes(cfg: "ArchConfig", batch: int, max_len: int,
                         kv_cache_dtype: str = "bf16") -> S.Expr:
    """Serve-cost-model entry point: cache bytes as an Expr over the
    tuner symbols ``dp`` / ``tp``."""
    layout = derive_cache_layout(cfg, batch, max_len, kv_cache_dtype)
    return S.wrap(cache_bytes(layout, dp=S.Sym("dp"), tp=S.Sym("tp"),
                              ops=SYMBOLIC_OPS))


def concrete_cache_bytes(cfg: "ArchConfig", batch: int, max_len: int,
                         kv_cache_dtype: str, *, dp_size: int,
                         tp_size: int) -> float:
    """Lowering entry point: exact bytes from the stage's ACTUAL mesh
    axis sizes (folded tp=1 meshes count the real mesh, exactly like
    ``stage_layout_terms``)."""
    layout = derive_cache_layout(cfg, batch, max_len, kv_cache_dtype)
    return cache_bytes(layout, dp=float(dp_size), tp=float(tp_size),
                       ops=CONCRETE_OPS)


# ---------------------------------------------------------------------------
# The serve-shape transient/total formulas, shared verbatim by the
# symbolic model and the concrete report so the two sides stay bitwise.
# ---------------------------------------------------------------------------


def prefill_transient_bytes(act_coef_full: float, d_model: float,
                            batch, seq_len, dp, tp) -> Any:
    """One-shot prefix cost envelope: a couple of layers' activations for
    the local token slab plus logits headroom (the dry-run's historical
    serve-path formula, now the single definition)."""
    tok_local = batch * seq_len / dp
    return (4.0 * act_coef_full * d_model * tok_local / tp) + float(2**30)


def serve_device_bytes(*, weight, cache, transient, reserved) -> Any:
    """Total per-device serve bytes, summed in the exact order
    ``StageMemory.device_bytes`` adds its (partly zero) terms — adding
    0.0 is the float identity for finite terms, so
    ``((weight + cache) + transient) + reserved`` is that sum."""
    return ((weight + cache) + transient) + reserved
