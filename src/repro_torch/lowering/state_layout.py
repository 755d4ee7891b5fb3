"""The ONE state-layout derivation shared by the tuner and the lowering.

Before this module, the semantics of "where does optimizer/weight/grad
state live" existed twice and disagreed:

* ``core/costmodel.py`` charged state as a uniform ``n / tp`` division
  with continuous offload ratios applied to *all* state, while
* ``lowering/memory.py`` counted real shard counts from the
  PartitionSpec tables (indivisible dims replicate!), integer WO/OO
  split points, and offload restricted to stacked-layer entries.

The gap was up to ~21% of predicted memory on indivisible-vocab archs
(granite-3-8b vocab 49155 at tp=8) — enough to pick wrong plans right at
the budget boundary where Mist's dual-objective constrained optimization
operates.  This module is the single source of truth both sides now
evaluate:

* **symbolically** — shard counts as :mod:`repro_torch.core.symbolic` ``Expr``
  chains over the tuner's knob symbols (``tp``/``dp``/``z1..z3``/``wo``/
  ``oo``/``L``), so the compiled tapes, the G-collapsed sweep, and the
  knob-tuple caches keep working unchanged;
* **concretely** — exact per-device bytes for
  ``LoweredPlan.memory_report()``, which is now a thin evaluation of the
  same layout.

Both paths run the *same* formula code (``state_terms``) over the same
deterministic tensor grouping; only the tiny ``Ops`` adapter differs
(float select / ``%`` divisibility vs ``Expr`` blend / ``ceil``-chain
divisibility).  Every produced value is exact in float64 — shard counts
are small integers, indicators are 0/1, split points are ``rint`` of
exact products — so symbolic and concrete evaluation agree **bitwise**
(property-tested in ``tests/test_state_layout.py``).

The physical-dim choosers (``choose_tp_dim`` / ``choose_fsdp_dim``) live
here as well: they are pure shape/axes logic, the same as the reference's
(its ``parallel/sharding.py`` re-exports them; the port's sharding waits
for ROADMAP.md's lowering item).

A copy of ``repro/lowering/state_layout.py``: only
:func:`derive_state_layout` differs, reading the param shapes and axes of
the port's builders on the meta device instead of jax's ``eval_shape``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core import symbolic as S

# logical axes eligible for tensor parallelism, in priority order
TP_PRIORITY = ("expert", "mlp", "heads", "inner2", "inner", "kv_heads",
               "vocab")
# leading stacked-scan dims — never sharded (scan slices them)
LAYER_AXES = ("layers", "layers1", "layers2")

_SHARED_PREFIXES = ("shared/", "shared_attn/")


# ---------------------------------------------------------------------------
# Physical-dim choosers (moved verbatim from repro_torch.parallel.sharding, which
# re-exports them; PartitionSpec construction and this module's concrete
# shard counts share these single implementations)
# ---------------------------------------------------------------------------


def choose_tp_dim(axes: Sequence[Optional[str]], shape: Sequence[int],
                  tp_size: int, ep_ok: bool) -> Optional[int]:
    """Pick the dim to shard over the model axis (None -> replicate)."""
    if tp_size <= 1:
        return None
    best = None
    best_rank = len(TP_PRIORITY)
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if ax is None or ax in LAYER_AXES or ax not in TP_PRIORITY:
            continue
        if ax == "expert" and not ep_ok:
            continue
        if dim % tp_size != 0:
            continue
        rank = TP_PRIORITY.index(ax)
        if rank < best_rank:
            best, best_rank = i, rank
    return best


def choose_fsdp_dim(axes: Sequence[Optional[str]], shape: Sequence[int],
                    fsdp_size: int, taken: Optional[int]) -> Optional[int]:
    """Largest free dim divisible by the ZeRO axis size."""
    if fsdp_size <= 1:
        return None
    best, best_dim = None, 0
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if i == taken or ax in LAYER_AXES:
            continue
        if dim % fsdp_size != 0:
            continue
        if dim > best_dim:
            best, best_dim = i, dim
    return best


# ---------------------------------------------------------------------------
# Layout derivation: abstract params -> deterministic tensor groups
# ---------------------------------------------------------------------------


def param_class(name: str, axes: Sequence[Optional[str]]) -> str:
    """stacked (per-layer scan entries) | shared (Zamba2-style block,
    replicated to every stage) | embed (embedding/head/final norm,
    attributed to the first and last stage)."""
    if axes and axes[0] in LAYER_AXES:
        return "stacked"
    if name.startswith(_SHARED_PREFIXES):
        return "shared"
    return "embed"


@dataclass(frozen=True)
class TensorGroup:
    """Tensors indistinguishable to the layout: same class, shape, and
    logical axes shard identically, split identically, and carry the same
    stage fraction — so they are summed once (``n`` = members * prod)."""
    cls: str                             # stacked | shared | embed
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    n: float                             # total elements across members
    names: Tuple[str, ...]


@dataclass(frozen=True)
class StateLayout:
    arch: str
    total_layers: int
    num_experts: int
    groups: Tuple[TensorGroup, ...]


_LAYOUT_CACHE: Dict[ArchConfig, StateLayout] = {}


def derive_state_layout(cfg: ArchConfig) -> StateLayout:
    """Group the arch's params (meta-device shapes) by (class, shape,
    axes), in first-appearance order (deterministic: the builders emit
    params in a fixed order, the reference's)."""
    hit = _LAYOUT_CACHE.get(cfg)
    if hit is not None:
        return hit
    from repro_torch.core.costmodel_params import meta_params

    params, axes_table = meta_params(cfg)
    order: list = []
    acc: Dict[Tuple, Tuple[float, list]] = {}
    for name, p in params.items():
        axes = tuple(axes_table[name])
        shape = tuple(int(d) for d in p.shape)
        cls = param_class(name, axes)
        key = (cls, shape, axes)
        if key not in acc:
            acc[key] = (0.0, [])
            order.append(key)
        n, names = acc[key]
        acc[key] = (n + float(np.prod(shape, dtype=np.float64)),
                    names + [name])
    groups = tuple(TensorGroup(cls=k[0], shape=k[1], axes=k[2],
                               n=acc[k][0], names=tuple(acc[k][1]))
                   for k in order)
    layout = StateLayout(arch=cfg.name, total_layers=int(cfg.num_layers),
                         num_experts=int(cfg.num_experts), groups=groups)
    _LAYOUT_CACHE[cfg] = layout
    return layout


# ---------------------------------------------------------------------------
# The two evaluation adapters.  ``state_terms`` below is written once
# against this tiny interface; floats and Exprs flow through the *same*
# arithmetic, in the same order, which is what makes the two modes agree
# bitwise (indicators are exactly 0.0/1.0, so the symbolic blend
# ``c*a + (1-c)*b`` equals the concrete select exactly).
# ---------------------------------------------------------------------------


class SymbolicOps:
    """Expr-producing adapter (the cost-model tapes)."""
    @staticmethod
    def where(c, a, b):
        return S.where(S.wrap(c), a, b)

    @staticmethod
    def rint(x):
        return S.rint(x)

    @staticmethod
    def divisible(dim: float, by) -> Any:
        # ceil(d/by)*by >= d always, with equality iff by divides d (for
        # the integer-valued, double-exact dims and axis sizes used here)
        return (S.ceil(S.wrap(dim) / by) * by) <= dim

    @staticmethod
    def gt(a, b):
        return S.wrap(a) > b


class ConcreteOps:
    """Float adapter (memory_report; the runtime's integer semantics)."""
    @staticmethod
    def where(c, a, b):
        return a if c else b

    @staticmethod
    def rint(x):
        return float(np.rint(x))     # == Python round(): half to even

    @staticmethod
    def divisible(dim: float, by) -> float:
        return 1.0 if int(dim) % max(1, int(by)) == 0 else 0.0

    @staticmethod
    def gt(a, b) -> float:
        return 1.0 if a > b else 0.0


SYMBOLIC_OPS = SymbolicOps()
CONCRETE_OPS = ConcreteOps()


def _group_shards(g: TensorGroup, num_experts: int, tp, dp, z1, z2, z3,
                  ops) -> Tuple[Any, Any, Any]:
    """(weight, grad, opt) shard counts of one group — the symbolic twin
    of ``choose_tp_dim`` / ``choose_fsdp_dim`` feeding ``param_spec`` /
    ``grad_spec`` / ``opt_spec``:

    * TP takes the first dim in (priority rank, index) order whose size
      the model-axis degree divides (the ``expert`` axis additionally
      requires ``num_experts % tp == 0``, mirroring ``ep_ok``);
    * the ZeRO/FSDP axis takes the largest remaining dim its degree
      divides — at ZeRO>=3 for weights, >=2 for grads, >=1 for
      master/mu/nu, exactly the spec-table thresholds.

    The chains are selection cascades over 0/1 indicators, so with
    concrete inputs they reproduce the choosers' picks identically."""
    dims = [float(d) for d in g.shape]
    tp_on = ops.gt(tp, 1.0)
    avail = tp_on
    tp_any = 0.0
    tp_take: Dict[int, Any] = {}
    tp_order = sorted((TP_PRIORITY.index(ax), i)
                      for i, ax in enumerate(g.axes)
                      if ax in TP_PRIORITY and ax not in LAYER_AXES)
    for _rank, i in tp_order:
        d = ops.divisible(dims[i], tp)
        if g.axes[i] == "expert":
            d = d * ops.divisible(float(num_experts), tp)
        take = avail * d
        tp_take[i] = take
        tp_any = tp_any + take
        avail = avail * (1.0 - d)
    fs_avail = ops.gt(dp, 1.0)
    fsdp_any = 0.0
    fs_order = sorted(range(len(dims)),
                      key=lambda j: (-dims[j], j))
    for j in fs_order:
        if g.axes[j] in LAYER_AXES:
            continue
        d = ops.divisible(dims[j], dp) * (1.0 - tp_take.get(j, 0.0))
        take = fs_avail * d
        fsdp_any = fsdp_any + take
        fs_avail = fs_avail * (1.0 - d)
    tp_sh = ops.where(tp_any, tp, 1.0)
    w_sh = tp_sh * ops.where(z3 * fsdp_any, dp, 1.0)
    g_sh = tp_sh * ops.where(z2 * fsdp_any, dp, 1.0)
    o_sh = tp_sh * ops.where(z1 * fsdp_any, dp, 1.0)
    return w_sh, g_sh, o_sh


def state_terms(layout: StateLayout, *, tp, dp, z1, z2, z3, wo, oo, L,
                total_layers: Optional[int] = None,
                has_embed: bool = True, has_head: bool = True,
                ops=SYMBOLIC_OPS) -> Dict[str, Any]:
    """Per-device state bytes of one stage, by term.

    Returns ``{"weight", "grad", "master", "opt", "host"}``: bf16
    weights, f32 grad accumulator, f32 master (device part), f32 mu+nu
    (device part), and the WO/OO slices living in host memory.  Stacked
    groups contribute their ``L / total_layers`` share; shared blocks
    replicate to every stage; embed/head groups charge the first and
    last stage in full (the cost model's attribution).  Host offload is
    the runtime's: integer leading-slice splits (``rint(ratio * lead)``,
    the exact ``optimizer.split_k`` count) on stacked entries only —
    non-stacked state cannot offload, and the grad accumulator never
    does (the runtime implements no grad offload).

    All inputs may be floats (``ConcreteOps``) or ``Expr``s
    (``SymbolicOps``); both take the same arithmetic path."""
    total = float(total_layers if total_layers is not None
                  else layout.total_layers)
    frac_stacked = L / total
    out: Dict[str, Any] = dict(weight=0.0, grad=0.0, master=0.0, opt=0.0,
                               host=0.0)
    for g in layout.groups:
        if g.cls == "stacked":
            frac = frac_stacked
        elif g.cls == "shared":
            frac = 1.0
        elif has_embed or has_head:
            frac = 1.0
        else:
            continue
        w_sh, g_sh, o_sh = _group_shards(g, layout.num_experts, tp, dp,
                                         z1, z2, z3, ops)
        n = g.n * frac
        if g.axes and g.axes[0] in LAYER_AXES:
            lead = float(g.shape[0])
            dev_m = (lead - ops.rint(wo * lead)) / lead
            dev_o = (lead - ops.rint(oo * lead)) / lead
        else:
            dev_m = dev_o = 1.0
        out["weight"] = out["weight"] + 2.0 * n / w_sh
        out["grad"] = out["grad"] + 4.0 * n / g_sh
        out["master"] = out["master"] + 4.0 * n * dev_m / o_sh
        out["opt"] = out["opt"] + 8.0 * n * dev_o / o_sh
        out["host"] = out["host"] + (4.0 * n * (1.0 - dev_m)
                                     + 8.0 * n * (1.0 - dev_o)) / o_sh
    return out


def symbolic_state_terms(cfg: ArchConfig, *, has_embed: bool,
                         has_head: bool) -> Dict[str, S.Expr]:
    """The cost-model entry point: terms as Exprs over the tuner symbols
    (``tp``, ``dp``, ``z1``/``z2``/``z3``, ``wo``, ``oo``, ``L``)."""
    terms = state_terms(
        derive_state_layout(cfg),
        tp=S.Sym("tp"), dp=S.Sym("dp"),
        z1=S.Sym("z1"), z2=S.Sym("z2"), z3=S.Sym("z3"),
        wo=S.Sym("wo"), oo=S.Sym("oo"), L=S.Sym("L"),
        has_embed=has_embed, has_head=has_head, ops=SYMBOLIC_OPS)
    return {k: S.wrap(v) for k, v in terms.items()}


def concrete_state_terms(cfg: ArchConfig, *, tp_size: int, fsdp_size: int,
                         zero: int, wo: float, oo: float, layers: int,
                         total_layers: int, has_embed: bool,
                         has_head: bool) -> Dict[str, float]:
    """The lowering entry point: exact bytes for one stage, from the
    plan's integer mesh degrees (``tp_size``/``fsdp_size`` are the
    *actual* axis sizes of the lowered stage's MeshAxes, so folded
    tp=1 meshes and production views evaluate correctly)."""
    z = float(zero)
    return state_terms(
        derive_state_layout(cfg),
        tp=float(tp_size), dp=float(fsdp_size),
        z1=1.0 if z >= 1 else 0.0, z2=1.0 if z >= 2 else 0.0,
        z3=1.0 if z >= 3 else 0.0,
        wo=float(wo), oo=float(oo), L=float(layers),
        total_layers=total_layers,
        has_embed=has_embed, has_head=has_head, ops=CONCRETE_OPS)
