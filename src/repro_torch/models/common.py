"""Shared model machinery (the port of ``repro/models/common.py``).

Params are a *flat dict* ``{"path/to/param": Tensor}`` with the reference's
names and stacked-layer shapes (leading ``L`` dim, or ``(groups, per)``
dims for the hybrid's Mamba stack), so weights cross
between the two packages by name (``repro_torch.bridge``).  The layer loop
is a Python loop over views ``w[i]`` of the stacked tensors (``layer``),
which a train step's ``GradSink`` takes into the graph; a caller that
makes the params autograd leaves itself unbinds them once per loss
instead (``unbind_layers``).

``segmented_layer_scan`` realises a plan's CKPT_i/AO_i as the reference
does, as segments ``[offload-remat | remat | saved]`` of the layer loop:
remat is ``torch.utils.checkpoint`` (non-reentrant), and the offload
segment also moves the layer inputs that checkpoint saves to pinned host
memory (``OffloadActivations``).  ``name_act`` is not ported: the offload
hook needs no activation tags.

Multi-device training (the counterpart of the reference's ``ShardRules`` /
``use_rules`` / ``shard_act``): the reference constrains activations and
lets XLA insert the collectives; the port writes them out.  ``Parallel``
carries one rank's process groups, its coordinates and the sequence-
parallel flag, and rides in ``ExecConfig.par`` (None on one device), so a
layer recomputed under ``checkpoint`` in the backward sees the same groups.
The collectives are autograd Functions over plain tensors:

* copy-to-tp: identity forward, all-reduce backward (the input of a
  column-parallel product, without sequence parallelism);
* reduce-from-tp: all-reduce forward, identity backward (the output of a
  row-parallel product, and the vocab-parallel loss's partial sums);
* gather-sequence: all-gather forward, reduce-scatter backward (the input
  of the vocab-parallel loss under sequence parallelism; the column-
  parallel products gather inside their own Function, which keeps only
  this rank's part of the input for the backward and gathers it again);
* scatter-sequence: reduce-scatter forward, all-gather backward (the
  output of a row-parallel product under sequence parallelism);
* sum-over-tp: all-reduce forward and backward (a sum every rank's output
  depends on: the Mamba mixer's gated norm over d_inner);
* gather-columns: all-gather of the ranks' equal parts of the last dim,
  keeping given columns; its backward reduce-scatters the kept columns'
  gradients (the Mamba mixer's fused projection, whose tp parts are not
  whole heads);
* gather-replicated: all-gather along a dim forward, and a backward that
  keeps this rank's part of the gradient and sums nothing (a value every
  tp rank then uses identically, so each rank's gradient of it is already
  whole: the MoE router's expert columns and, under sequence
  parallelism, its logits).

Gradients (``GradSink``, in ``ExecConfig.sink`` while a train step runs):
the params are no autograd leaves.  Each use of a param -- layer l's slice
of a stacked weight, the final norm, the embedding's lookup and, tied, its
head -- enters the graph through a sink whose backward adds that use's
gradient in f32 into the param's accumulator (``sums[name][l]`` for a
layer, ``sums[name][g, l]`` for a layer of the hybrid's Mamba stack; a
param used more than once, as the hybrid's shared block is, adds each
use's gradient into the same sum) and hands nothing back, so no whole
bf16 gradient of a stacked weight is ever made.  Under ZeRO 2 the sink reduce-scatters the gradient
over ``data`` before it adds it; under ZeRO 3 it also all-gathers the
weight over ``data`` in the forward (per layer, inside the layer's body,
so a remat'd layer gathers again in the backward).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
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
    # this rank's place in a multi-device plan (``Parallel``); None on one
    # device
    par: Any = None
    # where a train step's gradients go (``GradSink``); None when the caller
    # takes gradients itself (autograd leaves) or runs without autograd
    sink: Any = None
    # serving on a rank: the group that splits the decode cache's KV
    # sequence (``KVSplit``), and the weights ZeRO 3 splits over data,
    # gathered at each use (``WeightGather``); None where there are none
    kv_split: Any = None
    zero3: Any = None

    def replace(self, **kw) -> "ExecConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Multi-device execution: one rank's groups and the TP / SP / ZeRO collectives
# ---------------------------------------------------------------------------


# torch 2.13 renames the two collectives below; the names used are the
# ones both it and the card's torch 2.11 have
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(all_gather_into_tensor|"
            r"reduce_scatter_tensor)` is deprecated")


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' parts of ``x`` concatenated along ``dim`` in rank order."""
    xt = x.movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of the ranks' ``x``, cut into equal parts along ``dim``:
    rank r keeps part r."""
    xt = x.movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    if xt.shape[0] % n:
        raise ValueError(f"dim {x.shape[dim]} does not split into {n}")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=group)
    return x


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverTP(torch.autograd.Function):
    """All-reduce forward and backward: a sum over the tp ranks that every
    rank's output depends on (the gated norm's sum of squares), so each
    rank's gradient of it is the sum of the ranks' gradients."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _GatherColumns(torch.autograd.Function):
    """The ranks' equal parts of the last dim all-gathered, and only the
    columns ``ranges`` (``(lo, hi)`` pairs of the whole last dim) kept, in
    that order.  The backward puts each kept column's gradient back in its
    place, zeros elsewhere, and reduce-scatters in f32: a column that
    several ranks keep gets the sum of their gradients."""
    @staticmethod
    def forward(ctx, x, group, ranges):
        n, c = dist.get_world_size(group), x.shape[-1]
        ctx.group, ctx.shape = group, tuple(x.shape)
        ctx.pieces = []      # (rank, lo, hi) of its part, in order
        for a, b in ranges:
            while a < b:
                k, lo = divmod(a, c)
                hi = min(c, lo + b - a)
                ctx.pieces.append((k, lo, hi))
                a += hi - lo
        parts = x.new_empty((n * ctx.shape[0],) + ctx.shape[1:])
        dist.all_gather_into_tensor(parts, x.contiguous(), group=group)
        parts = parts.view((n,) + ctx.shape)
        return torch.cat([parts[k][..., lo:hi] for k, lo, hi in ctx.pieces],
                         -1)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        shape = ctx.shape
        full = g.new_zeros((n * shape[0],) + shape[1:], dtype=torch.float32)
        parts, at = full.view((n,) + shape), 0
        for k, lo, hi in ctx.pieces:
            parts[k][..., lo:hi] = g[..., at:at + hi - lo]
            at += hi - lo
        out = full.new_empty(shape)
        dist.reduce_scatter_tensor(out, full, group=ctx.group)
        return out.to(g.dtype), None, None


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter backward (the
    gradient summed in f32 and returned in the input's dtype)."""
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g.float(), ctx.dim, ctx.group).to(
            g.dtype), None, None


class _ScatterDim(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` forward; the backward keeps this rank's
    part of the gradient, summing nothing: what the gather feeds is
    computed identically on every rank of ``group``, so the gradient of
    the gathered tensor is the same, and whole, on each."""
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), \
            None, None


class _GatheredProducts(torch.autograd.Function):
    """``x`` gathered along the sequence, times each of ``ws``: the
    column-parallel products under sequence parallelism.  Saves this
    rank's part of ``x`` and gathers it again in the backward, so the
    gathered copy lives only while the products run (the memory model
    charges a layer's activations divided by tp); the gradient of x is
    reduce-scattered in f32."""
    @staticmethod
    def forward(ctx, x, group, *ws):
        ctx.group = group
        ctx.save_for_backward(x, *ws)
        xf = all_gather_dim(x, 1, group)
        return tuple(xf @ w for w in ws)

    @staticmethod
    def backward(ctx, *gys):
        x, *ws = ctx.saved_tensors
        xf = all_gather_dim(x, 1, ctx.group)
        rows = xf.reshape(-1, xf.shape[-1])
        dws = [rows.T @ gy.reshape(-1, gy.shape[-1]) for gy in gys]
        dx = sum(gy @ w.T for gy, w in zip(gys, ws))
        dx = reduce_scatter_dim(dx.float(), 1, ctx.group).to(x.dtype)
        return (dx, None, *dws)


class Parallel:
    """One rank of a ``(data, model)`` mesh running a single-stage plan.

    ``dp_group``/``tp_group`` are the mesh's process groups, ``dp_rank``/
    ``tp_rank`` its coordinates.  ``sp``: the residual stream is split
    along the sequence over ``model`` (sequence parallelism, tp > 1)."""

    def __init__(self, dp_group, tp_group, dp: int, tp: int, dp_rank: int,
                 tp_rank: int, sp: bool):
        self.dp_group, self.tp_group = dp_group, tp_group
        self.dp, self.tp = dp, tp
        self.dp_rank, self.tp_rank = dp_rank, tp_rank
        self.sp = sp

    def tp_in(self, x: torch.Tensor) -> torch.Tensor:
        """Into the tp region: the full sequence on every tp rank."""
        if self.sp:
            return _GatherDim.apply(x, 1, self.tp_group)
        return _CopyToTP.apply(x, self.tp_group)

    def column(self, x: torch.Tensor, *ws: torch.Tensor):
        """``x @ w`` for each column-parallel ``w`` (this rank's columns),
        ``x`` entering the tp region."""
        if self.sp:
            return _GatheredProducts.apply(x, self.tp_group, *ws)
        x = _CopyToTP.apply(x, self.tp_group)
        return tuple(x @ w for w in ws)

    def tp_out(self, y: torch.Tensor) -> torch.Tensor:
        """Out of a row-parallel product: the partial sums added, and under
        sequence parallelism this rank's part of the sequence kept."""
        if self.sp:
            return _ScatterDim.apply(y, 1, self.tp_group)
        return _ReduceFromTP.apply(y, self.tp_group)

    def reduce_from_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromTP.apply(x, self.tp_group)

    def copy_to_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, the gradient summed over tp: a value every tp
        rank holds whole and uses on its own part of the work (the MoE's
        gates, which each rank's experts combine with)."""
        return _CopyToTP.apply(x, self.tp_group)

    def gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The tp ranks' parts of ``x`` along ``dim``; the gradient
        reduce-scattered (each rank's is a partial sum)."""
        return _GatherDim.apply(x, dim, self.tp_group)

    def gather_replicated(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The tp ranks' parts of ``x`` along ``dim``, for a use that every
        rank computes identically (``_GatherReplicated``)."""
        return _GatherReplicated.apply(x, dim, self.tp_group)

    def sum_tp(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the tp ranks, its gradient summed too."""
        return _SumOverTP.apply(x, self.tp_group)

    def gather_columns(self, x: torch.Tensor, ranges) -> torch.Tensor:
        """The columns ``ranges`` of the last dim that tp splits ``x``'s
        parts of (``_GatherColumns``)."""
        return _GatherColumns.apply(x, self.tp_group, tuple(ranges))

    def seq_part(self, x: torch.Tensor) -> torch.Tensor:
        """This tp rank's part of dim 1 (the sequence)."""
        n = x.shape[1] // self.tp
        return x[:, self.tp_rank * n:(self.tp_rank + 1) * n]



class _Sink(torch.autograd.Function):
    """``w`` as the graph uses it (all-gathered along ``dim`` over
    ``group`` when ``gather``); the backward adds the gradient into ``acc``
    in f32, reduce-scattered along ``dim`` first when ``dim`` is set, and
    returns nothing.  ``anchor`` is the step's one leaf that requires grad,
    so that the graph reaches every sink."""
    @staticmethod
    def forward(ctx, anchor, w, acc, dim, group, gather):
        ctx.acc, ctx.dim, ctx.group = acc, dim, group
        if gather:
            return all_gather_dim(w, dim, group)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        if ctx.dim is None:
            ctx.acc.add_(g)
        else:
            ctx.acc.add_(reduce_scatter_dim(g.float(), ctx.dim, ctx.group))
        return (None,) * 6


class GradSink:
    """The f32 gradient accumulators of one train step (module docstring).

    ``sums``: name -> this rank's f32 accumulator (the grad spec's shard,
    zeros at the start of the step).  ``scatter``: name -> the dim the
    gradient is reduce-scattered along over ``group`` (the grad spec's
    ``"data"`` entry, ZeRO 2 and 3); ``gather``: the names whose weight is
    split over ``group`` too (ZeRO 3: the param spec splits the same dim)
    and is all-gathered along that dim.  Dims count the stacked param's
    own; a layer's slice drops the leading one."""

    def __init__(self, sums: Params, scatter: Optional[Dict[str, int]] = None,
                 gather: Sequence[str] = (), group=None):
        self.sums = sums
        self.scatter, self.gather = dict(scatter or {}), frozenset(gather)
        assert self.gather <= set(self.scatter), self.gather
        self.group = group
        dev = next(iter(sums.values())).device
        self.anchor = torch.zeros((), device=dev, requires_grad=True)

    def take(self, name: str, w: torch.Tensor,
             layer: Union[int, Tuple[int, ...], None] = None) -> torch.Tensor:
        """``w`` (the param ``name``, or its slice ``layer``: an index into
        its one leading stacked dim, or a tuple of indices into as many,
        as the hybrid's ``(groups, per)`` Mamba stack takes ``(g, l)``)
        entering the graph.  A param used several times (the hybrid's
        shared block, once per group) is taken once per use, and each use's
        gradient adds into the same sum."""
        acc, lead = self.sums[name], 0
        if layer is not None:
            idx = layer if isinstance(layer, tuple) else (layer,)
            acc, lead = acc[idx], len(idx)
        d = self.scatter.get(name)
        return _Sink.apply(self.anchor, w, acc,
                           None if d is None else d - lead, self.group,
                           name in self.gather)

    def params(self, params: Params, prefix: str = "",
               layer: Union[int, Tuple[int, ...], None] = None) -> Params:
        """``take`` of each of ``params``, named ``prefix + name``."""
        return {n: self.take(prefix + n, w, layer)
                for n, w in params.items()}


def in_use(params: Params, ec: ExecConfig, prefix: str = "",
           layer: Union[int, Tuple[int, ...], None] = None) -> Params:
    """``params`` as the graph uses them: through the train step's sink
    when there is one (``GradSink.params``), gathered where a serving
    rank's ZeRO 3 splits them (``WeightGather.params``), else as they
    are."""
    if ec.sink is not None:
        return ec.sink.params(params, prefix, layer)
    if ec.zero3 is not None:
        return ec.zero3.params(params, prefix, layer)
    return params


# ---------------------------------------------------------------------------
# Serving on a rank: ZeRO-3 weights and a split KV sequence
# ---------------------------------------------------------------------------


class WeightGather:
    """The weights of a serving rank that ZeRO 3 splits over ``data``:
    ``dims`` maps each such param to the dim its spec splits (of the
    stacked param), and each use all-gathers it over ``group`` -- a layer's
    slices inside the layer loop, one layer at a time, as training's
    forward gathers them (``GradSink``), so no rank holds more than one
    layer of a split param whole."""

    def __init__(self, dims: Dict[str, int], group):
        self.dims, self.group = dict(dims), group

    def params(self, params: Params, prefix: str = "",
               layer: Union[int, Tuple[int, ...], None] = None) -> Params:
        lead = 0 if layer is None else \
            len(layer) if isinstance(layer, tuple) else 1
        return {n: all_gather_dim(w, self.dims[prefix + n] - lead, self.group)
                if prefix + n in self.dims else w
                for n, w in params.items()}


@dataclass(frozen=True)
class KVSplit:
    """The ranks that split a decode cache's KV sequence into ``size``
    equal parts (``sharding.cache_specs``): the ``model`` group where tp
    does not divide the KV heads and dp took the batch, the ``data`` group
    where dp does not divide the batch.  Rank ``rank`` of ``group`` holds
    positions ``[rank · S / size, (rank + 1) · S / size)``."""
    axis: str
    group: Any
    size: int
    rank: int


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
                 dtype=torch.bfloat16, device: Union[str, torch.device] = "cpu",
                 shard: Optional[Callable] = None,
                 layers: Optional[Tuple[int, int]] = None,
                 keep: Optional[Callable[[str], bool]] = None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        # shard(name, x, lead): this rank's part of x, the whole param
        # (lead 0) or one slice of its ``lead`` leading layer dims.  Every
        # rank draws the same numbers and keeps its part.
        self.shard = shard
        # a pipeline stage's part: the layers [start, stop) of each stacked
        # param, and only the params ``keep`` names; every param is still
        # drawn, so the kept numbers are the whole model's
        self.layers = layers
        self.keep = keep
        self.params: Params = {}
        self.axes: Axes = {}

    def _part(self, name: str, x: torch.Tensor, lead: int) -> torch.Tensor:
        return x if self.shard is None else self.shard(name, x, lead)

    def _local(self, name: str, shape, lead: int) -> Tuple[int, ...]:
        """This rank's shape of the param: its stage's layers of a stacked
        param, its part of every dim the shard splits."""
        local = list(self._part(name, torch.empty(shape, device="meta"),
                                0).shape)
        if lead and self.layers is not None:
            assert lead == 1, "a layer range cuts one stacked dim"
            local[0] = self.layers[1] - self.layers[0]
        return tuple(local)

    def _normal(self, name: str, shape, scale: float, dtype, lead: int,
                kept: bool) -> torch.Tensor:
        local = self._local(name, shape, lead) if kept else (0,)
        out = torch.empty(local, dtype=dtype, device=self.device)
        if out.is_meta:          # a shape probe: nothing to draw
            return out
        # stacked params (``lead`` leading layer dims) are drawn one layer at
        # a time, so the f32 draw stays one layer large at full width; the
        # rest in one draw
        rows = out.view(-1, *local[lead:]) if lead else out.unsqueeze(0)
        lo = self.layers[0] if lead and self.layers is not None else 0
        full = tuple(shape[lead:])
        for j in range(math.prod(shape[:lead])):
            x = torch.randn(full, generator=self.generator,
                            dtype=torch.float32, device=self.device)
            if kept and 0 <= j - lo < rows.shape[0]:
                rows[j - lo].copy_(self._part(name, x, lead).mul_(scale))
        return out

    def add(self, name: str, shape: Tuple[int, ...],
            axes: Tuple[Optional[str], ...], init: str = "normal",
            scale: Optional[float] = None, dtype=None) -> None:
        assert len(shape) == len(axes), (name, shape, axes)
        assert name not in self.params, f"duplicate param {name}"
        dtype = dtype or self.dtype
        kept = self.keep is None or self.keep(name)
        lead = next((i for i, ax in enumerate(axes)
                     if not (ax or "").startswith("layers")), len(axes))
        if init in ("zeros", "ones"):
            v = (torch.zeros if init == "zeros" else torch.ones)(
                self._local(name, tuple(shape), lead) if kept else (0,),
                dtype=dtype, device=self.device)
        elif init == "normal":
            if scale is None:  # fan-in scaling over the (stacked) shape
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(1, fan_in))
            v = self._normal(name, tuple(shape), scale, dtype, lead, kept)
        else:
            raise ValueError(init)
        if kept:
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
                 mask: Optional[torch.Tensor] = None,
                 denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy; logits (..., V) f32, labels int.
    ``denom``: the masked sum's divisor in place of the mask count."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.float()
        if denom is None:
            denom = torch.clamp_min(torch.sum(mask), 1.0)
        return torch.sum(nll * mask) / denom
    return torch.mean(nll)
