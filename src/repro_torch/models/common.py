"""Shared model machinery (the port of ``repro/models/common.py``).

Params are a *flat dict* ``{"path/to/param": Tensor}`` with the reference's
names and stacked-layer shapes (leading ``L`` dim, or ``(groups, per)``
dims for the hybrid's Mamba stack), so weights cross
between the two packages by name (``repro_torch.bridge``).  The layer loop
is a Python loop over views ``w[i]`` of the stacked tensors.

``shard_act``/``name_act`` are no-ops on one device and are not ported;
``segmented_layer_scan`` belongs to the training slice.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
Axes = Dict[str, Tuple[Optional[str], ...]]

# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The port's entry points run on ``cuda`` unless the caller asks for
    the CPU.  With no CUDA device and no such request this raises: the port
    never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' (--device cpu) to run the plain CPU path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# Execution config (runtime knobs; plan-dependent, never changes the math)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExecConfig:
    ckpt_layers: int = 10**9
    attn_impl: str = "naive"          # naive | blocked | pallas
    offload_layers: int = 0
    remat_policy: str = "full"        # full | dots | none
    use_pallas: bool = False
    moe_group_size: int = 4096
    # the reference's TPU tiles (plan.kernel); the plain blocked attention
    # uses them, the Hopper kernels pick their own (docs/port.md)
    attn_q_block: int = 512
    attn_kv_block: int = 512
    rmsnorm_block: int = 256
    ssd_chunk: int = 256
    mlstm_chunk: int = 256
    compute_dtype: Any = torch.bfloat16
    logits_dtype: Any = torch.float32
    sequence_parallel: bool = True
    cache_update: str = "dus"
    # "kernel": CUDA tensors launch the Hopper kernels, CPU tensors take the
    # plain versions.  "plain": the plain versions everywhere -- a test hook
    # that lets a run on the card compare the model against itself.
    kernel_impl: str = "kernel"

    def replace(self, **kw) -> "ExecConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Param builder
# ---------------------------------------------------------------------------


class ParamBuilder:
    """Creates params with the reference's names, shapes and init scales.

    The values come from ``generator`` (a ``torch.Generator`` on
    ``device``); they are not the reference's values, which come from
    ``jax.random``.  Tests that compare the packages cross weights through
    ``repro_torch.bridge`` instead.
    """

    def __init__(self, generator: Optional[torch.Generator],
                 dtype=torch.bfloat16, device: Union[str, torch.device] = "cpu"):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.params: Params = {}
        self.axes: Axes = {}

    def _normal(self, shape, scale: float, dtype) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype, device=self.device)
        # stacked params are drawn one layer at a time so the f32 draw stays
        # one layer large at full width
        rows = out.view(-1, *shape[-2:]) if len(shape) >= 3 \
            else out.unsqueeze(0)
        for r in rows:
            r.copy_(torch.randn(r.shape, generator=self.generator,
                                dtype=torch.float32, device=self.device)
                    .mul_(scale))
        return out

    def add(self, name: str, shape: Tuple[int, ...],
            axes: Tuple[Optional[str], ...], init: str = "normal",
            scale: Optional[float] = None, dtype=None) -> None:
        assert len(shape) == len(axes), (name, shape, axes)
        assert name not in self.params, f"duplicate param {name}"
        dtype = dtype or self.dtype
        if init == "zeros":
            v = torch.zeros(shape, dtype=dtype, device=self.device)
        elif init == "ones":
            v = torch.ones(shape, dtype=dtype, device=self.device)
        elif init == "normal":
            if scale is None:  # fan-in scaling over the (stacked) shape
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(1, fan_in))
            v = self._normal(tuple(shape), scale, dtype)
        else:
            raise ValueError(init)
        self.params[name] = v
        self.axes[name] = tuple(axes)

    def scope(self, prefix: str) -> "ScopedBuilder":
        return ScopedBuilder(self, prefix)


class ScopedBuilder:
    def __init__(self, parent, prefix: str):
        self._p = parent
        self._prefix = prefix

    def add(self, name, *a, **kw):
        self._p.add(f"{self._prefix}/{name}", *a, **kw)

    def scope(self, prefix: str):
        return ScopedBuilder(self._p, f"{self._prefix}/{prefix}")

    @property
    def dtype(self):
        return self._p.dtype


class StackedBuilder(ScopedBuilder):
    """Adds params with leading stacked-layer dim(s).

    ``num_layers`` may be an int or a tuple (nested stacks, e.g. Zamba2's
    (groups, layers-per-group)); the leading axes are named ``layers``,
    ``layers1``, ... as in the reference."""

    def __init__(self, parent, prefix: str,
                 num_layers: Union[int, Tuple[int, ...]]):
        super().__init__(parent, prefix)
        self._L = (num_layers,) if isinstance(num_layers, int) \
            else tuple(num_layers)

    def add(self, name, shape, axes, **kw):
        lead_axes = tuple(f"layers{i if i else ''}"
                          for i in range(len(self._L)))
        super().add(name, self._L + tuple(shape), lead_axes + tuple(axes),
                    **kw)

    def scope(self, prefix: str):
        return StackedBuilder(self._p, f"{self._prefix}/{prefix}", self._L)


# -- flat-dict utilities -----------------------------------------------------


def subtree(params: Params, prefix: str) -> Params:
    """View of all params under ``prefix/`` with the prefix stripped."""
    pl = prefix + "/"
    return {k[len(pl):]: v for k, v in params.items() if k.startswith(pl)}


def layer(params: Params, i: int) -> Params:
    """Layer ``i`` of a stacked flat dict: views ``w[i]``, no copies."""
    return {k: v[i] for k, v in params.items()}
