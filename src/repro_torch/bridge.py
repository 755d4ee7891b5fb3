"""Weights, serving state and train state across the two packages, through
numpy.

The reference's flat param dict (stacked names included: ``(L, ...)`` and
the hybrid's ``(groups, per, ...)``) and its cache trees (the dense
``{k, v, pos}`` and the hybrid's nested ``{"attn", "mamba"}``) cross by
name with identical shapes.  numpy has no bf16, so bf16 crosses as
f32 (exact) and is rounded back here (exact again).  A train state
``{"step", "params", "master", "mu", "nu"}`` crosses leaf by leaf, split
leaves ``{"host", "dev"}`` included.  A rank's shards of a multi-device
train state cross whole: ``gather_train_state`` assembles the full state
on rank 0, ``shard_train_state`` cuts a rank's part of a full one (both by
``LoweredPlan.state_specs``).  A pipelined plan's state crosses the same
way across its stages: each stage's stacked layers in their place in the
whole stack, the embedding, head and final norm from the first stage, and
every optimizer leaf whole (the stages split their host parts by their own
WO/OO, so a gathered leaf joins its host and device parts).  A rank's cut
joins any split leaf of the full state and splits it again by its own
stage's WO/OO, so a state gathered under one plan places onto any other
plan of the same model (``load_train_state`` writes it into a live state
in place).  ``shard_params`` cuts a whole model's params into a serving
rank's, by the same param specs.  Every array or tensor these functions
return is a copy the caller owns: none is a view of a live tensor that a
later step writes.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

Device = Union[str, torch.device]


def _to_torch(arr, dtype: Optional[torch.dtype], device: Device
              ) -> torch.Tensor:
    """An array or a tensor as a new tensor (a copy) on ``device``;
    floating ones cast to ``dtype``."""
    t = arr.detach().clone() if isinstance(arr, torch.Tensor) else \
        torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """An owned numpy copy (never a view of a CPU tensor); bf16 as f32."""
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """An owned CPU copy of ``t`` in its own dtype (bf16 kept)."""
    return t.detach().to("cpu", copy=True)


def params_from_numpy(flat: Mapping[str, np.ndarray], *,
                      dtype: Optional[torch.dtype] = None,
                      device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor}; floating arrays cast to ``dtype``."""
    return {n: _to_torch(a, dtype, device) for n, a in flat.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """{name: tensor} -> {name: array}; bf16 becomes f32."""
    return {n: _to_numpy(t) for n, t in params.items()}


_F32_CACHE_KEYS = ("ssm", "k_scale", "v_scale")


def caches_from_numpy(tree: Mapping, *, dtype: Optional[torch.dtype] = None,
                      device: Device = "cpu") -> Dict:
    """A cache tree -- dense ``{k, v, pos}`` or the hybrid's ``{"attn":
    {k, v, pos}, "mamba": {conv, ssm}}``, with the int8 layout's
    ``k_scale``/``v_scale`` -- leaf by leaf: ``pos`` as int32, the SSM state
    ``ssm`` and the scales as f32 (they are f32 in both packages), int8
    codes as int8, every other floating leaf cast to ``dtype``."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out[key] = caches_from_numpy(val, dtype=dtype, device=device)
        elif key == "pos":
            out[key] = _to_torch(np.asarray(val, np.int32), None, device)
        else:
            out[key] = _to_torch(val, torch.float32 if key in _F32_CACHE_KEYS
                                 else dtype, device)
    return out


def caches_to_numpy(caches: Mapping) -> Dict:
    """The same tree with numpy leaves; bf16 becomes f32."""
    return {key: caches_to_numpy(val) if isinstance(val, Mapping)
            else _to_numpy(val) for key, val in caches.items()}


def _state_leaf_from_numpy(val, device: torch.device) -> object:
    """An f32 optimizer leaf: a split ``{"host", "dev"}`` keeps its host part
    on the CPU (pinned when ``device`` is CUDA)."""
    if isinstance(val, Mapping):
        host = _to_torch(val["host"], torch.float32, "cpu")
        if device.type == "cuda":
            host = host.pin_memory()
        return {"host": host,
                "dev": _to_torch(val["dev"], torch.float32, device)}
    return _to_torch(val, torch.float32, device)


def train_state_from_numpy(tree: Mapping, *,
                           param_dtype: torch.dtype = torch.bfloat16,
                           device: Device = "cpu") -> Dict:
    """The reference's train state as numpy -> the port's: ``step`` int32,
    ``params`` in ``param_dtype``, master/mu/nu f32 (split leaves kept)."""
    device = torch.device(device)
    return {
        "step": _to_torch(np.asarray(tree["step"], np.int32), None, device),
        "params": params_from_numpy(tree["params"], dtype=param_dtype,
                                    device=device),
        **{e: {n: _state_leaf_from_numpy(v, device)
               for n, v in tree[e].items()}
           for e in ("master", "mu", "nu")},
    }


def train_state_to_numpy(state: Mapping) -> Dict:
    """The port's train state -> numpy leaves (bf16 as f32, ``step`` as an
    int32 scalar, split leaves as ``{"host", "dev"}``)."""
    if state["step"].is_cuda:
        # adam_update writes the host parts back with non-blocking copies
        torch.cuda.synchronize(state["step"].device)

    def leaf(v):
        if isinstance(v, Mapping):
            return {k: _to_numpy(x) for k, x in v.items()}
        return _to_numpy(v)

    return {
        "step": np.asarray(_to_numpy(state["step"]), np.int32),
        "params": params_to_numpy(state["params"]),
        **{e: {n: leaf(v) for n, v in state[e].items()}
           for e in ("master", "mu", "nu")},
    }


def _lowered(cfg, plan, mesh):
    from repro_torch.lowering import lower_plan
    return lower_plan(cfg, None, plan, mesh)


def _cat(parts):
    """Arrays or tensors joined along their first dim (tensors on the
    last part's device)."""
    if isinstance(parts[-1], torch.Tensor):
        return torch.cat([p.to(parts[-1].device) for p in parts])
    return np.concatenate(parts)


def _joined(v):
    """A split leaf ``{"host", "dev"}`` as one tensor or array."""
    if not isinstance(v, Mapping):
        return v
    return _cat([v["host"], v["dev"]])


def gather_train_state(state: Mapping, cfg, plan, mesh,
                       keep_dtype: bool = False) -> Optional[Dict]:
    """One rank's shards of a train state (``training.step.
    init_sharded_state``) -> the full state as numpy on rank 0 (None on the
    other ranks), in ``train_state_to_numpy``'s form (a pipelined plan's
    optimizer leaves whole, module docstring).  ``keep_dtype``: leaves as
    owned CPU tensors in their own dtype (``host_copy``; bf16 kept, the
    checkpointer's form) instead of numpy.  Every rank must call it: each
    shard is all-gathered over the mesh axes its spec names, and each
    stage's first rank sends its stage's part to rank 0."""
    from repro_torch.launch.mesh import mesh_coords
    from repro_torch.models.common import all_gather_dim
    dev = state["step"].device
    if dev.type == "cuda":
        # adam_update writes the host parts back with non-blocking copies
        torch.cuda.synchronize(dev)
    low = _lowered(cfg, plan, mesh)
    coords = mesh_coords(mesh)
    stage = coords.get("stage", 0)
    specs = low.state_specs(stage)
    piped = len(low.stages) > 1
    lead = coords["data"] == coords["model"] == 0
    keep = dist.get_rank() == 0 or (piped and lead)
    out_of = host_copy if keep_dtype else _to_numpy

    def whole(t, spec):
        t = t.to(dev)
        for d, ax in enumerate(spec):
            if ax is not None:
                t = all_gather_dim(t, d, mesh.get_group(ax))
        return out_of(t) if keep else None

    def leaf(v, spec):
        if isinstance(v, Mapping):
            parts = {k: whole(x, spec[k]) for k, x in v.items()}
            return _joined(parts) if piped and keep else parts
        return whole(v, spec)

    out = {"step": out_of(state["step"]) if keep_dtype else
           np.asarray(_to_numpy(state["step"]), np.int32)}
    for e in ("params", "master", "mu", "nu"):
        out[e] = {n: leaf(v, specs[e][n]) for n, v in state[e].items()}
    if not piped:
        return out if keep else None
    parts = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object((stage, out) if keep else None, parts, dst=0)
    if dist.get_rank() != 0:
        return None
    stages = dict(p for p in parts if p is not None)
    full = {"step": stages[0]["step"]}
    for e in ("params", "master", "mu", "nu"):
        full[e] = {}
        for n, v in stages[0][e].items():
            full[e][n] = v if not n.startswith("layers/") else \
                _cat([stages[i][e][n] for i in sorted(stages)])
    return full


def _rank_part(full: Mapping, cfg, plan, mesh) -> Dict:
    """This rank's part of a full train state (numpy arrays or CPU
    tensors, split leaves or whole), as views where it can: its stage's
    layers and params (the whole model's on a single-stage plan), each
    leaf joined and split again by its stage's WO/OO, then cut by its
    spec.  ``mesh`` None: the one device of a dp = tp = 1 plan."""
    from repro_torch.lowering import plan_mesh, shard_tensor
    from repro_torch.parallel.sharding import mesh_shape
    from repro_torch.training.optimizer import split_k
    if mesh is None:
        low = _lowered(cfg, plan, plan_mesh(plan))
        sizes = mesh_shape(low.mesh)
        coords = {n: 0 for n in sizes}
    else:
        from repro_torch.launch.mesh import mesh_coords
        low = _lowered(cfg, plan, mesh)
        sizes, coords = mesh_shape(mesh), mesh_coords(mesh)
    stage = coords.get("stage", 0)
    specs = low.state_specs(stage)
    ls = low.stages[stage]
    lo, hi = ls.layers
    metas, axes = low.stage_params(stage)
    ratio = {"master": ls.stage.wo, "mu": ls.stage.oo, "nu": ls.stage.oo}

    def mine(e, n, v):
        if isinstance(v, Mapping):
            rows = v["host"].shape[0] + v["dev"].shape[0]
            shape = (rows,) + tuple(v["dev"].shape[1:])
            # whole for this stage: not cut by layers (the hybrid's stacks
            # lead with groups), or all of them
            whole = not n.startswith("layers/") or (lo, hi) == (0, rows)
            if whole and v["host"].shape[0] == split_k(
                    n, shape, axes, ratio.get(e, 0.0)):
                return v            # already split as this stage splits it
        v = _joined(v)
        if n.startswith("layers/"):
            v = v[lo:hi]
        k = split_k(n, tuple(v.shape), axes, ratio.get(e, 0.0))
        return {"host": v[:k], "dev": v[k:]} if k else v

    def cut(v, spec):
        if isinstance(v, Mapping):
            return {k: cut(x, spec[k]) for k, x in v.items()}
        return shard_tensor(v, spec, sizes, coords)

    return {"step": full["step"], **{
        e: {n: cut(mine(e, n, full[e][n]), specs[e][n]) for n in metas}
        for e in ("params", "master", "mu", "nu")}}


def shard_params(flat: Mapping[str, np.ndarray], cfg, plan, mesh, *,
                 dtype: Optional[torch.dtype] = None,
                 device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """A whole model's params (the reference's, as numpy) -> this rank's
    serving params on a single-stage plan's live ``mesh``: each cut by the
    param specs ``_rank_part`` cuts a train state's params by (tp, and
    data under ZeRO 3), floating ones cast to ``dtype``."""
    from repro_torch.launch.mesh import mesh_coords
    from repro_torch.lowering import shard_tensor
    from repro_torch.parallel.sharding import mesh_shape
    low = _lowered(cfg, plan, mesh)
    sizes, coords = mesh_shape(mesh), mesh_coords(mesh)
    return {n: _to_torch(shard_tensor(flat[n], spec, sizes, coords), dtype,
                         device)
            for n, spec in low.param_specs(0).items()}


def shard_train_state(full: Mapping, cfg, plan, mesh, *,
                      param_dtype: torch.dtype = torch.bfloat16,
                      device: Device = "cpu") -> Dict:
    """A full train state (``train_state_to_numpy``'s form, a pipelined
    plan's ``gather_train_state``, or a checkpoint's CPU tensors; split
    leaves or whole, by any WO/OO) -> this rank's part of it, on
    ``device``, split by its stage's WO/OO (``mesh`` None: one device)."""
    return train_state_from_numpy(_rank_part(full, cfg, plan, mesh),
                                  param_dtype=param_dtype, device=device)


def load_train_state(into: Dict, full: Mapping, cfg, plan, mesh) -> Dict:
    """``shard_train_state`` written into the live state ``into`` in place
    (``copy_``): its device tensors and pinned host parts stay, and no
    second copy of the state is made on the device.  Returns ``into``."""
    part = _rank_part(full, cfg, plan, mesh)

    def put(dst, src, what):
        if isinstance(dst, Mapping) != isinstance(src, Mapping):
            raise ValueError(f"{what}: split differently from the live "
                             "state")
        if isinstance(dst, Mapping):
            for k in dst:
                put(dst[k], src[k], f"{what}/{k}")
            return
        src = src if isinstance(src, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(src))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{what}: shape {tuple(src.shape)} for a live "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)

    with torch.no_grad():
        for e in ("params", "master", "mu", "nu"):
            if set(part[e]) != set(into[e]):
                raise ValueError(f"{e}: the live state holds other params")
            for n, v in into[e].items():
                put(v, part[e][n], f"{e}/{n}")
        into["step"].copy_(torch.as_tensor(np.asarray(part["step"],
                                                      np.int32)))
    return into
