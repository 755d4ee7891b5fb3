"""Shared model machinery (the port of ``repro/models/common.py``).

Params are a *flat dict* ``{"path/to/param": Tensor}`` with the reference's
names and stacked-layer shapes (leading ``L`` dim, or ``(groups, per)``
dims for the hybrid's Mamba stack), so weights cross
between the two packages by name (``repro_torch.bridge``).  The layer loop
is a Python loop: serving takes views ``w[i]`` of the stacked tensors
(``layer``); training unbinds them once per loss (``unbind_layers``).

``segmented_layer_scan`` realises a plan's CKPT_i/AO_i as the reference
does, as segments ``[offload-remat | remat | saved]`` of the layer loop:
remat is ``torch.utils.checkpoint`` (non-reentrant), and the offload
segment also moves the layer inputs that checkpoint saves to pinned host
memory (``OffloadActivations``).  ``shard_act``/``name_act`` are no-ops on
one device and are not ported: the offload hook needs no activation tags.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

Params = Dict[str, torch.Tensor]
Axes = Dict[str, Tuple[Optional[str], ...]]

# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def resolve_device(device: Union[str, torch.device, None] = None, *,
                   allow_meta: bool = False) -> torch.device:
    """The port's entry points run on ``cuda`` unless the caller asks for
    the CPU.  With no CUDA device and no such request this raises: the port
    never carries on on the CPU by itself.  ``allow_meta`` also accepts the
    meta device, for shape probes (the tuner's param and cache layouts)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' (--device cpu) to run the plain CPU path")
    elif dev.type != "cpu" and not (allow_meta and dev.type == "meta"):
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

    def _normal(self, shape, scale: float, dtype, lead: int) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype, device=self.device)
        if out.is_meta:          # a shape probe: nothing to draw
            return out
        # stacked params (``lead`` leading layer dims) are drawn one layer at
        # a time, so the f32 draw stays one layer large at full width; the
        # rest in one draw
        rows = out.view(-1, *shape[lead:]) if lead else out.unsqueeze(0)
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
            lead = next((i for i, ax in enumerate(axes)
                         if not (ax or "").startswith("layers")), len(axes))
            v = self._normal(tuple(shape), scale, dtype, lead)
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


def unbind_layers(stacked: Params, num_layers: int) -> List[Params]:
    """The per-layer dicts of a stacked flat dict, from one ``unbind`` per
    tensor.  Under autograd, ``unbind``'s backward stacks the per-layer
    gradients once; indexing ``w[i]`` per layer (``layer``) would instead
    give each layer's view a zero gradient of the whole stacked size."""
    names = list(stacked)
    per = [stacked[n].unbind(0) for n in names]
    assert all(len(t) == num_layers for t in per), num_layers
    return [dict(zip(names, ts)) for ts in zip(*per)]


# ---------------------------------------------------------------------------
# Segmented layer loop with per-segment remat (CKPT_i / AO_i realization)
# ---------------------------------------------------------------------------

# bytes of activations the offload hook has taken in this process (moved to
# pinned host memory on a CUDA device; kept where they are on the CPU)
OFFLOADED_BYTES = 0


class OffloadActivations(torch.autograd.graph.saved_tensors_hooks):
    """Saved-tensor hooks that move activations to pinned host memory.

    Around a non-reentrant checkpoint these see what checkpoint itself
    saves: the layer's input (the residual stream) and the layer's
    parameter views.  Tensors whose storage is one of ``params``' are left
    in place, so only activations move.  On a CUDA tensor, pack copies to a
    pinned host buffer (asynchronously, on the current stream) and unpack
    copies back; on the CPU both are no-ops, as the reference keeps the
    offload segment resident when the backend has no host memory space."""

    def __init__(self, params: Sequence[torch.Tensor]):
        keep = {t.untyped_storage().data_ptr() for t in params}

        def pack(t):
            global OFFLOADED_BYTES
            if t.untyped_storage().data_ptr() in keep:
                return t
            OFFLOADED_BYTES += t.numel() * t.element_size()
            if t.device.type != "cuda":
                return t
            host = torch.empty(t.size(), dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return t.device, host

        def unpack(packed):
            if isinstance(packed, tuple):
                dev, host = packed
                return host.to(dev, non_blocking=True)
            return packed

        super().__init__(pack, unpack)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of plain matmuls and recompute everything else (the
    batched products included), as ``checkpoint_dots_with_no_batch_dims``
    does in the reference."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_call(body: Callable, carry, lp: Params, policy: str,
                offload: bool):
    """``body(carry, lp)`` for one layer, under the segment's remat."""
    if policy == "none" and not offload:
        return body(carry, lp)
    names = list(lp)

    def fn(h, *tensors):
        return body((h,) + tuple(carry[1:]), dict(zip(names, tensors)))

    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if offload:
        with OffloadActivations(lp.values()):
            return checkpoint(fn, carry[0], *lp.values(), **kw)
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    elif policy != "full":
        raise ValueError(policy)
    return checkpoint(fn, carry[0], *lp.values(), **kw)


def segmented_layer_scan(body: Callable, carry, layers: Sequence[Params],
                         num_layers: int, exec_cfg: ExecConfig):
    """The layer loop, split into [offload-remat | remat | saved].

    ``body(carry, layer_params) -> carry``, with the residual stream first
    in ``carry``.  The first ``offload_layers`` rematerialize *and* offload
    their saved inputs to host; the next ``ckpt - offload`` only
    rematerialize (under ``remat_policy``); the rest save all
    intermediates.  This realizes Mist's (CKPT_i, AO_i) knobs as the
    reference's scan-split points; with autograd off (serving) checkpoint
    runs its function plainly."""
    ckpt = min(exec_cfg.ckpt_layers, num_layers)
    off = min(exec_cfg.offload_layers, ckpt)
    segments = []  # (start, stop, policy, offload)
    if off:
        segments.append((0, off, exec_cfg.remat_policy, True))
    if ckpt - off:
        segments.append((off, ckpt, exec_cfg.remat_policy, False))
    if num_layers - ckpt:
        segments.append((ckpt, num_layers, "none", False))
    for lo, hi, policy, offload in segments:
        for i in range(lo, hi):
            carry = _remat_call(body, carry, layers[i], policy, offload)
    return carry


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy; logits (..., V) f32, labels int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
