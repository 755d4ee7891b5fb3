"""Process groups and the device mesh of a multi-device run (the port of
``repro/launch/mesh.py``).

One process per device.  ``init_distributed`` joins the default process
group as ``torchrun`` describes it (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; ``launch/train.py
--nproc`` sets the same variables for the ranks it spawns): NCCL with rank
r on ``cuda:<LOCAL_RANK>``, gloo when the caller asks for the CPU.  A
process that has already joined a group (a caller's own, of any backend)
keeps it.  ``make_plan_mesh`` lays the world out as the plan's ``(data,
model)`` mesh; ranks ``d · tp + t`` share data coordinate ``d``.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple, Union

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


def make_plan_mesh(dp: int, tp: int, device: Union[str, torch.device]):
    """The ``(data, model)`` DeviceMesh of a plan over the initialised
    default group, whose size must be dp · tp."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if dp * tp != world:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} ranks; the "
                         f"world has {world}")
    return init_device_mesh(torch.device(device).type, (dp, tp),
                            mesh_dim_names=("data", "model"))


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a live mesh."""
    return {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}
