"""Sharding rules: logical param axes -> mesh axes (the port of
``repro/parallel/sharding.py``).

A pure spec library.  A spec is a tuple with one entry per tensor dim:
``None`` (replicated), ``"data"`` or ``"model"``, the mesh axis that dim is
split over.  ``param_spec`` / ``opt_spec`` / ``grad_spec`` choose the dims
with ``choose_tp_dim`` / ``choose_fsdp_dim`` (``lowering/state_layout.py``,
the same choosers the tuner's memory tape evaluates), so what a rank holds
is what the tuner charged.  ``lowering/lower.py`` assembles the per-stage
tables; the runtime (``training/step.py``) cuts and moves shards by them
with explicit ``torch.distributed`` collectives.

Meshes are either an ``AbstractMesh`` (axis names and sizes, no devices:
the lowering and the memory report) or a live
``torch.distributed.device_mesh.DeviceMesh``; ``mesh_shape`` reads both.
An axis of size 1 shards nothing, so a spec never names one.
``cache_specs`` and ``cache_update_mode`` place a serving cache tree the
same way, leaf by leaf (``lowering/lower.py::LoweredPlan.cache_specs``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.lowering.state_layout import choose_fsdp_dim, choose_tp_dim

Spec = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class AbstractMesh:
    """A device-less mesh: axis names and their sizes (the counterpart of
    the reference's ``compat.abstract_mesh``)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} do not match "
                             f"axis names {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, of an ``AbstractMesh`` or a live ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class MeshAxes:
    """Physical axis names of the active mesh."""
    dp: Tuple[str, ...] = ("data",)      # data parallelism (+ "pod" outer)
    tp: Optional[str] = "model"          # tensor parallelism
    fsdp: Tuple[str, ...] = ("data",)    # ZeRO sharding axis (== dp here)

    @staticmethod
    def from_mesh(mesh) -> "MeshAxes":
        names = tuple(mesh_shape(mesh))
        dp = tuple(n for n in names if n in ("pod", "data", "replica"))
        tp = "model" if "model" in names else None
        return MeshAxes(dp=dp or (names[0],), tp=tp, fsdp=dp or (names[0],))


def axis_size(mesh, axes) -> int:
    """Total device count of a MeshAxes role (None -> 1, tuples multiply)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _entry(mesh, axes):
    """The spec entry of a role: its axes of size > 1 (one name, or a
    tuple when several are), None when it has none."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    live = tuple(a for a in axes if shape[a] > 1)
    if not live:
        return None
    return live[0] if len(live) == 1 else live


def param_spec(name: str, shape: Sequence[int], axes: Sequence[Optional[str]],
               mesh, ma: MeshAxes, *, zero3: bool, ep_ok: bool) -> Spec:
    tp_size = axis_size(mesh, ma.tp)
    spec: list = [None] * len(shape)
    ti = choose_tp_dim(axes, shape, tp_size, ep_ok)
    if ti is not None:
        spec[ti] = _entry(mesh, ma.tp)
    if zero3:
        fi = choose_fsdp_dim(axes, shape, axis_size(mesh, ma.fsdp), ti)
        if fi is not None:
            spec[fi] = _entry(mesh, ma.fsdp)
    return tuple(spec)


def opt_spec(name: str, shape, axes, mesh, ma: MeshAxes, *,
             zero: int, ep_ok: bool) -> Spec:
    """Optimizer-state / master-weight sharding (ZeRO>=1 shards over fsdp)."""
    return param_spec(name, shape, axes, mesh, ma, zero3=zero >= 1,
                      ep_ok=ep_ok)


def grad_spec(name: str, shape, axes, mesh, ma: MeshAxes, *,
              zero: int, ep_ok: bool) -> Spec:
    """Gradient sharding: ZeRO>=2 reduce-scatters grads over fsdp."""
    return param_spec(name, shape, axes, mesh, ma, zero3=zero >= 2,
                      ep_ok=ep_ok)


def make_shard_rules(mesh, ma: MeshAxes, sequence_parallel: bool
                     ) -> Dict[str, Optional[str]]:
    """Logical activation axis -> mesh axis: ``dp`` (the batch), ``tp``
    (heads and d_ff), ``sp`` (the residual stream's sequence, live only
    with sequence parallelism and tp > 1)."""
    tp_size = axis_size(mesh, ma.tp)
    return {"dp": _entry(mesh, ma.dp), "tp": _entry(mesh, ma.tp),
            "sp": _entry(mesh, ma.tp) if (sequence_parallel and tp_size > 1)
            else None}


# ---------------------------------------------------------------------------
# Cache (serving) specs
# ---------------------------------------------------------------------------

# the cache leaves that carry the KV sequence at ``bdim + 1`` (the
# reference's ``_SEQ_LEAF_SEQ_DIM`` keys)
SEQ_CACHE_KEYS = ("k", "v", "latent", "k_rope", "k_scale", "v_scale")


def cache_specs(caches, mesh, ma: MeshAxes, batch: int,
                batch_dims: Optional[Dict[Tuple[str, ...], Optional[int]]]
                = None) -> Any:
    """The spec of every leaf of a stacked cache tree (a nested dict of
    tensors, meta ones included), as the same tree of specs: the
    reference's ``cache_specs`` leaf for leaf, in the port's form.

    The batch dim is located by value (the first dim equal to ``batch``).
    A batch that dp divides (dp > 1) splits over ``data``; otherwise the KV
    sequence (``bdim + 1`` of the ``SEQ_CACHE_KEYS`` leaves) takes
    ``data``.  Over ``model``: k/v on their KV-head dim when tp divides
    it, else on the sequence when ``data`` did not take it; the state
    leaves ``ssm``/``c``/``n``/``m`` on their heads; ``conv`` on its
    channels; MLA's ``latent``/``k_rope`` on the sequence; ``k_scale``/
    ``v_scale`` as k/v.  The reference names ``data`` on the sequence even
    where dp is 1 (a split into one part), and that is what keeps tp off
    it: so at dp = 1 a k/v whose heads tp does not divide stays whole over
    ``model``.  The spec names only axes of size > 1.

    ``batch_dims`` (leaf path -> its batch dim or None) replaces the search
    by value: where the batch equals another dim of a leaf (the stacked
    layers, at batch = num_layers), the reference splits that dim; the
    runtime passes the batch dims its probe established
    (``cache_layout.derive_cache_layout``), the memory model keeps the
    reference's search."""
    dp_size, tp_size = axis_size(mesh, ma.dp), axis_size(mesh, ma.tp)
    dp, tp = _entry(mesh, ma.dp), _entry(mesh, ma.tp)
    shard_batch = batch % dp_size == 0 and dp_size > 1

    def leaf_spec(path, shape):
        key, nd = path[-1], len(shape)
        spec: list = [None] * nd
        # the dims the reference names an axis on, of any size
        taken = [False] * nd
        bdim = next((i for i, d in enumerate(shape) if d == batch), None) \
            if batch_dims is None else batch_dims[path]
        if bdim is None:
            return tuple(spec)

        def put(i, entry):
            spec[i], taken[i] = entry, True

        if shard_batch:
            put(bdim, dp)
        elif key in SEQ_CACHE_KEYS and nd > bdim + 1:
            put(bdim + 1, dp)      # the KV sequence over data
        if tp_size > 1:
            seq_free = nd > bdim + 1 and not taken[bdim + 1]
            if key in ("k", "v") and nd >= bdim + 3 \
                    and shape[nd - 2] % tp_size == 0:
                put(nd - 2, tp)    # (..., B, S, KV, hd): the KV heads
            elif key in ("k", "v") and seq_free \
                    and shape[bdim + 1] % tp_size == 0:
                put(bdim + 1, tp)  # heads tp does not divide: the sequence
            elif key in ("ssm", "c", "n", "m") and nd > bdim + 1 \
                    and shape[bdim + 1] % tp_size == 0:
                put(bdim + 1, tp)  # state heads
            elif key == "conv" and shape[nd - 1] % tp_size == 0:
                put(nd - 1, tp)    # conv channels
            elif key in ("latent", "k_rope") and seq_free \
                    and shape[bdim + 1] % tp_size == 0:
                put(bdim + 1, tp)  # MLA latent: the sequence
            elif key in ("k_scale", "v_scale"):
                # as k/v: the kv-head dim (last) if tp divides it, else the
                # sequence
                if shape[nd - 1] % tp_size == 0:
                    put(nd - 1, tp)
                elif seq_free and shape[bdim + 1] % tp_size == 0:
                    put(bdim + 1, tp)
        return tuple(spec)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else leaf_spec(path + (k,), tuple(int(d) for d in v.shape))
                for k, v in tree.items()}

    return walk(caches, ())


def cache_update_mode(specs, ma: MeshAxes) -> str:
    """``"onehot"`` when any KV-sequence leaf names the model axis on any
    dim (the reference's rule), else ``"dus"``: a decode then writes the new
    row only where the rank holds its position (``layers.cache_write``)."""
    tp = set(ma.tp if isinstance(ma.tp, tuple) else (ma.tp,)) - {None}

    def named(e):
        return set(e if isinstance(e, tuple) else (e,))

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                if walk(v):
                    return True
            elif k in SEQ_CACHE_KEYS and any(named(e) & tp for e in v
                                             if e is not None):
                return True
        return False

    return "onehot" if walk(specs) else "dus"


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A rank's shape of a tensor of ``shape`` split by ``spec``."""
    sizes = mesh_shape(mesh) if not isinstance(mesh, dict) else mesh
    return tuple(n if e is None else n // sizes[e]
                 for n, e in zip(shape, spec))
