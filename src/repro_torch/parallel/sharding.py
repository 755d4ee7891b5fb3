"""Mesh-axis roles for the lowering (the part of ``repro/parallel/sharding.py``
the memory report needs).

The reference's spec library maps each tensor's logical axes to a
PartitionSpec over a jax mesh.  The port lowers plans over an
``AbstractMesh``: axis names and sizes only, no devices, which is all the
state layout (``lowering/state_layout.py``) and the memory report read.
``MeshAxes`` says which mesh axes mean data, tensor and ZeRO parallelism;
``axis_size`` multiplies the sizes of one role.  The per-tensor spec
tables and their DTensor placements wait for the multi-device slice
(ROADMAP.md, queue A).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple


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


@dataclass(frozen=True)
class MeshAxes:
    """Physical axis names of the active mesh."""
    dp: Tuple[str, ...] = ("data",)      # data parallelism (+ "pod" outer)
    tp: Optional[str] = "model"          # tensor parallelism
    fsdp: Tuple[str, ...] = ("data",)    # ZeRO sharding axis (== dp here)

    @staticmethod
    def from_mesh(mesh: AbstractMesh) -> "MeshAxes":
        names = tuple(mesh.axis_names)
        dp = tuple(n for n in names if n in ("pod", "data", "replica"))
        tp = "model" if "model" in names else None
        return MeshAxes(dp=dp or (names[0],), tp=tp, fsdp=dp or (names[0],))


def axis_size(mesh: AbstractMesh, axes) -> int:
    """Total device count of a MeshAxes role (None -> 1, tuples multiply)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n
