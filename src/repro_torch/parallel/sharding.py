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
``cache_specs`` (serving) waits for multi-device serving (ROADMAP.md,
queue A item 8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

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
