"""Process groups and the device mesh of a multi-device run (the port of
``repro/launch/mesh.py``).

One process per device.  ``init_distributed`` joins the default process
group as ``torchrun`` describes it (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; ``launch/train.py
--nproc`` sets the same variables for the ranks it spawns): NCCL with rank
r on ``cuda:<LOCAL_RANK>``, gloo when the caller asks for the CPU.  A
process that has already joined a group (a caller's own, of any backend)
keeps it.  ``make_plan_mesh`` lays the world out as the plan's ``(data,
model)`` mesh, ranks ``d · tp + t`` sharing data coordinate ``d``; a
pipelined plan's as ``(stage, data, model)``, stage-major: stage s holds
ranks ``s · dp · tp + d · tp + t``, and an activation passes between the
ranks at the same (d, t) of stages s and s + 1 (``stage_peers``).
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.models.common import resolve_device


def init_distributed(device: Union[str, torch.device, None] = None
                     ) -> Tuple[int, int, torch.device]:
    """Join the default process group; returns (rank, world size, this
    rank's device).  On CUDA the backend is NCCL and nothing falls back to
    gloo or the CPU."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        try:
            rank, world = int(os.environ["RANK"]), \
                int(os.environ["WORLD_SIZE"])
        except KeyError as e:
            raise RuntimeError(f"{e.args[0]} is not set: start the ranks "
                               "with launch/train.py --nproc or torchrun")
        local = int(os.environ.get("LOCAL_RANK", rank))
        if dev.type == "cuda":
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
            dist.init_process_group("nccl", rank=rank, world_size=world,
                                    device_id=dev)
        else:
            dist.init_process_group("gloo", rank=rank, world_size=world)
    elif dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dist.get_rank(), dist.get_world_size(), dev


def make_plan_mesh(dp: int, tp: int, device: Union[str, torch.device],
                   stages: int = 1):
    """The ``(data, model)`` DeviceMesh of a plan over the initialised
    default group, whose size must be dp · tp; with ``stages`` > 1 the
    ``(stage, data, model)`` mesh of S · dp · tp ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    shape, names = (dp, tp), ("data", "model")
    if stages > 1:
        shape, names = (stages,) + shape, ("stage",) + names
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=names)


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a live mesh."""
    return {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}


def stage_peers(mesh) -> Tuple[Optional[int], Optional[int]]:
    """The global ranks at this rank's (data, model) coordinates in the
    stages before and after its own (None at the ends)."""
    c = mesh_coords(mesh)
    s, ranks = c["stage"], mesh.mesh

    def at(k):
        if 0 <= k < ranks.shape[0]:
            return int(ranks[k, c["data"], c["model"]])
        return None

    return at(s - 1), at(s + 1)


def end_stages_group(mesh):
    """The process group of the first and the last stage's ranks at this
    rank's (data, model) coordinates, which both hold the embedding, the
    head and the final norm (None on a middle stage).  Every rank of the
    world takes part in making the groups, one per (data, model) pair."""
    ranks, c = mesh.mesh, mesh_coords(mesh)
    if ranks.shape[0] == 2:
        return mesh.get_group("stage")
    mine = None
    for d in range(ranks.shape[1]):
        for t in range(ranks.shape[2]):
            g = dist.new_group([int(ranks[0, d, t]), int(ranks[-1, d, t])])
            if (d, t) == (c["data"], c["model"]):
                mine = g
    return mine if c["stage"] in (0, ranks.shape[0] - 1) else None
