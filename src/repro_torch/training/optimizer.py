"""Mixed-precision AdamW with host-offloadable state (the port of
``repro/training/optimizer.py``).

State layout (flat dicts keyed by param name), as in the reference:
  state = {"step": int32, "params": bf16, "master": f32, "mu": f32, "nu": f32}

Any of master/mu/nu may be *split* along the stacked-layer dim into
``{"host": x[:k], "dev": x[k:]}`` to realize Mist's WO/OO offload ratios:
master by WO, mu/nu by OO.  On a CUDA device the host part is a pinned CPU
tensor, staged through device memory for its update and copied back (the
reference's ``to_dev``/``to_host``); on the CPU it is a plain CPU tensor and
the staging is a no-op.  Overlapping those copies with the update (Mist's
repositioned optimizer step) is later work (ROADMAP.md).

The update runs in place on the state (the reference's jitted step donates
it instead) and takes the reference's f32 arithmetic step for step.

On a rank of a multi-device plan every tensor of the state is this rank's
shard (``lowering/lower.py``'s spec tables) and ``adam_update`` takes a
``StateSharding``: the grad norm counts every element once (shard sums
added over the axes a gradient is split over, never over those it is
replicated on); under ZeRO 1 each rank updates its ``data`` part of the
master/mu/nu from its part of the full gradient; under ZeRO 1 and 2 an
all-gather over ``data`` then refreshes the bf16 params.  The WO/OO host
splits cut the local shard's leading layer dim, which is never sharded.
On a stage of a pipelined plan the norm also adds over the stages, each
param counted once: the embedding, head and final norm that the first and
the last stage both hold count on the first.

The update and the norm's sums of squares walk each leaf in slices of its
leading (stacked-layer) dim, ``SLICE_ELEMS`` elements or one row at most
(``row_slices``), so that their f32 temporaries are one slice's, never a
whole leaf's (zamba2's stacked mixer ``in_proj`` is 5.78 GB in f32).  Adam
is elementwise, so the sliced update is bitwise the whole-leaf one; a leaf
of one slice also keeps the whole-leaf sum of squares bit for bit, and a
larger one adds its slices' sums in order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.plan import StageConfig
from repro_torch.models.common import Axes, Params

# the stacked-layer axis names (a copy of the reference's
# ``lowering/state_layout.py:58``)
LAYER_AXES = ("layers", "layers1", "layers2")

# the most elements one slice of the update takes (2^26: 256 MB of f32), or
# one row of the leading dim where a row is larger.  On an H100 the update
# at 2^24 took 2-4 ms a step more than the whole-leaf update, at 2^26 1-2
# ms, at the same peak (PERF.md, ``chip_smoke.py --adam-slices``)
SLICE_ELEMS = 1 << 26


def row_slices(x: torch.Tensor):
    """``[(lo, hi)]`` over ``x``'s leading dim: runs of whole rows of at
    most ``SLICE_ELEMS`` elements (one row where a row holds more); one
    slice, ``(0, None)``, for a 0-d tensor."""
    if x.dim() == 0:
        return [(0, None)]
    n = x.shape[0]
    step = max(1, SLICE_ELEMS // max(1, x.numel() // max(1, n)))
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)]


def _rows(x: torch.Tensor, lo: int, hi) -> torch.Tensor:
    return x if hi is None else x[lo:hi]


def sum_squares(g: torch.Tensor) -> torch.Tensor:
    """sum(g^2) in f32, over ``row_slices``: a leaf of one slice is the
    whole-leaf ``torch.sum(torch.square(g.float()))`` bit for bit; a larger
    one adds its slices' sums in order."""
    total = None
    for lo, hi in row_slices(g):
        part = torch.sum(torch.square(_rows(g, lo, hi).float()))
        total = part if total is None else total + part
    return total


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def is_split(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"host", "dev"}


def split_k(name: str, shape, axes_table: Axes, ratio: float) -> int:
    """How many leading (stacked-layer) slices go to host for this tensor."""
    if ratio <= 0.0 or not shape:
        return 0
    axes = axes_table.get(name, ())
    if not axes or axes[0] not in LAYER_AXES:
        return 0
    return int(round(ratio * shape[0]))


def _host_empty(shape, like: torch.Tensor) -> torch.Tensor:
    """An f32 host buffer: pinned when the state lives on a CUDA device."""
    return torch.empty(shape, dtype=torch.float32,
                       pin_memory=like.device.type == "cuda")


# ---------------------------------------------------------------------------
# state init
# ---------------------------------------------------------------------------


def init_opt_entry(params: Params, axes_table: Axes, ratio: float,
                   like: str) -> Dict[str, Any]:
    """like: 'master' copies params to f32; 'zeros' makes f32 zeros.  A
    split leaf's device part is its own tensor (no view of a full one)."""
    out = {}
    for name, p in params.items():
        k = split_k(name, p.shape, axes_table, ratio)
        if not k:
            out[name] = p.detach().to(torch.float32, copy=True) \
                if like == "master" else \
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            continue
        host = _host_empty((k,) + tuple(p.shape[1:]), p)
        if like == "master":
            host.copy_(p[:k])
            dev = p[k:].detach().to(torch.float32, copy=True)
        else:
            host.zero_()
            dev = torch.zeros((p.shape[0] - k,) + tuple(p.shape[1:]),
                              dtype=torch.float32, device=p.device)
        out[name] = {"host": host, "dev": dev}
    return out


def init_state(params: Params, axes_table: Axes, stage: StageConfig,
               opt_params: Optional[Params] = None) -> Dict[str, Any]:
    """``opt_params``: what master/mu/nu are made from, when they are split
    finer than the params (this rank's ZeRO part of each); by default the
    params themselves."""
    dev = next(iter(params.values())).device
    src = params if opt_params is None else opt_params
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "params": dict(params),
        "master": init_opt_entry(src, axes_table, stage.wo, "master"),
        "mu": init_opt_entry(src, axes_table, stage.oo, "zeros"),
        "nu": init_opt_entry(src, axes_table, stage.oo, "zeros"),
    }


def _data_dim(spec) -> Optional[int]:
    return spec.index("data") if "data" in spec else None


class StateSharding:
    """Where one rank's state tensors sit on a ``(data, model)`` mesh: the
    param / grad / opt specs of every param name (``LoweredPlan``'s
    tables) and the rank's ``common.Parallel`` (groups, coordinates).

    On a pipeline stage: ``stage_group``, the ranks at this rank's (data,
    model) coordinates in every stage; ``across_stages``, the names every
    stage holds a part of (the stacked layers); ``counted_elsewhere``, the
    names whose gradient another stage counts in the norm (the last
    stage's copy of what the first stage also holds)."""

    def __init__(self, pspecs: Mapping, gspecs: Mapping, ospecs: Mapping,
                 par, stage_group=None, across_stages=(),
                 counted_elsewhere=()):
        self.pspecs, self.gspecs, self.ospecs = pspecs, gspecs, ospecs
        self.par = par
        self.stage_group = stage_group
        self.across_stages = frozenset(across_stages)
        self.counted_elsewhere = frozenset(counted_elsewhere)

    def global_norm(self, grads: Params) -> torch.Tensor:
        """``global_norm`` of the whole gradient: each shard's sum of
        squares added over the axes its tensor is split over, then over the
        stages.  With nothing split it is ``global_norm``'s sum, bit for
        bit."""
        sums: Dict[Tuple[bool, bool], Any] = {}
        for n, g in grads.items():
            if n in self.counted_elsewhere:
                continue
            key = ("data" in self.gspecs[n], "model" in self.gspecs[n])
            sums[key] = sums.get(key, 0) + sum_squares(g)
        z = torch.zeros((), dtype=torch.float32,
                        device=next(iter(grads.values())).device)

        def part(key):
            return sums.get(key, z)

        d = torch.stack([part((True, False)), part((True, True))])
        dist.all_reduce(d, group=self.par.dp_group)
        m = torch.stack([part((False, True)), d[1]])
        dist.all_reduce(m, group=self.par.tp_group)
        total = part((False, False)) + d[0] + m[0] + m[1]
        if self.stage_group is not None:
            dist.all_reduce(total, group=self.stage_group)
        return torch.sqrt(total)

    def global_amax(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """max |g| over the whole tensor (``fake_compress``'s scale), the
        stacked layers of every stage included."""
        amax = torch.max(torch.abs(g))
        for ax, group in (("data", self.par.dp_group),
                          ("model", self.par.tp_group)):
            if ax in self.gspecs[name]:
                dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        if name in self.across_stages:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                            group=self.stage_group)
        return amax

    def opt_grad(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """The part of ``g`` this rank's master/mu/nu update: under ZeRO 1
        the rank's ``data`` part of the full gradient."""
        d = _data_dim(self.ospecs[name])
        if d is None or _data_dim(self.gspecs[name]) is not None:
            return g
        w = g.shape[d] // self.par.dp
        return g.narrow(d, self.par.dp_rank * w, w)

    def write_params(self, name: str, p: torch.Tensor,
                     master: torch.Tensor) -> None:
        """bf16 params from the updated master: all-gathered over ``data``
        where the master is split finer than the params (ZeRO 1 and 2)."""
        d = _data_dim(self.ospecs[name])
        if d is None or _data_dim(self.pspecs[name]) is not None:
            p.copy_(master)
            return
        from repro_torch.models.common import all_gather_dim
        p.copy_(all_gather_dim(master.to(p.dtype), d, self.par.dp_group))


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def global_norm(grads: Params) -> torch.Tensor:
    return torch.sqrt(sum(sum_squares(g) for g in grads.values()))


@torch.no_grad()
def adam_update(state: Dict[str, Any], grads: Params, acfg: AdamConfig,
                sharding: Optional[StateSharding] = None
                ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  grads: f32 flat dict (same keys as
    params).  Host parts of split leaves are staged through the params'
    device for the update and copied back; on a CUDA device the copy back
    is asynchronous, so synchronize before reading a host part on the host
    (``bridge.train_state_to_numpy`` does).  ``sharding``: the state is one
    rank's shards (module docstring)."""
    step = state["step"] + 1
    if sharding is None:
        gnorm = global_norm(grads)

        def write(name, p, master):
            p.copy_(master)
    else:
        gnorm = sharding.global_norm(grads)
        write = sharding.write_params
        grads = {n: sharding.opt_grad(n, g) for n, g in grads.items()}
    clip = torch.clamp(acfg.grad_clip / (gnorm + 1e-12), max=1.0)
    c1 = 1.0 - acfg.b1 ** step.float()
    c2 = 1.0 - acfg.b2 ** step.float()

    def upd(m, mu, nu, g):
        # slice by slice of the leading dim: the f32 temporaries are one
        # slice's
        for lo, hi in row_slices(g):
            gg = _rows(g, lo, hi).float() * clip
            m_, mu_, nu_ = (_rows(x, lo, hi) for x in (m, mu, nu))
            mu_.mul_(acfg.b1).add_((1 - acfg.b1) * gg)
            nu_.mul_(acfg.b2).add_((1 - acfg.b2) * gg * gg)
            u = (mu_ / c1) / (torch.sqrt(nu_ / c2) + acfg.eps)
            m_.sub_(acfg.lr * (u + acfg.weight_decay * m_))

    for name, g in grads.items():
        p = state["params"][name]
        leaves = [state[e][name] for e in ("master", "mu", "nu")]
        if not any(is_split(x) for x in leaves):
            upd(*leaves, g)
            write(name, p, leaves[0])
            continue
        kh = next(x["host"].shape[0] for x in leaves if is_split(x))
        for lo, hi in ((0, kh), (kh, g.shape[0])):
            parts, staged = [], []
            for x in leaves:
                if not is_split(x):
                    parts.append(x[lo:hi])
                elif lo == 0:   # the host part, staged on the device
                    parts.append(x["host"].to(p.device, non_blocking=True))
                    staged.append((x["host"], parts[-1]))
                else:
                    parts.append(x["dev"])
            upd(*parts, g[lo:hi])
            write(name, p[lo:hi], parts[0])
            for host, dev in staged:
                if dev is not host:
                    host.copy_(dev, non_blocking=True)

    state["step"] = step
    return state, {"grad_norm": gnorm}
