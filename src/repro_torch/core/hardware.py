"""Hardware model of the port's target, one NVIDIA H100 SXM5 80GB per device
(the copy of ``repro/core/hardware.py``, with the H100 in place of its TPU).

The fields are the reference's, so the cost model reads them unchanged; the
values are the card's data sheet unless a comment says otherwise.  The cost
model's other constants (``costmodel.CostParams``) are the reference's and
are not calibrated for Hopper yet (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "h100-sxm5-80gb"
    # data sheet: dense bf16 tensor-core rate per GPU (no sparsity)
    peak_flops_bf16: float = 989e12
    # data sheet: HBM3 bandwidth per GPU
    hbm_bw: float = 3.35e12
    # data sheet: 80 GB of HBM3 (decimal gigabytes)
    hbm_bytes: float = 80e9
    # data sheet: NVLink 4, 900 GB/s per GPU in total over 18 links, both
    # directions counted.  The cost model prices a collective at
    # ``ici_bw * ici_links`` bytes/s of wire per device; one direction is
    # half of the total, so 18 links of 25 GB/s = 450 GB/s.
    ici_bw: float = 25e9
    ici_links: int = 18
    # across hosts: one 400 Gb/s NIC per GPU (50 GB/s, the H100 HGX
    # reference design)
    dci_bw: float = 50e9
    # data sheet: PCIe Gen5 x16, 64 GB/s per direction.  Measured on one
    # H100 80GB HBM3 (700 W) for the WO/OO host copies of a train step:
    # 50.4 GB/s host to device, 54.2 GB/s device to host (PERF.md §5)
    host_bw: float = 64e9
    # the smallest tensor-core tile edge the kernels use (wgmma m64nNk16 is
    # issued per 64-row warpgroup tile)
    mxu_min_dim: int = 64
    # data sheet: 227 KB (232,448 B) of shared memory per block on sm_90,
    # under the reference's name (its TPU's VMEM): the budget of the cost
    # model's kernel working set (``vmem_peak``, the Hopper kernels' shared
    # memory a block, kernels/tiles.py) and of the kernel tuner's grid
    vmem_bytes: float = 232448.0
    # devices one fast fabric joins (``ici_bw``); a collective whose group
    # spans more is priced at ``dci_bw`` (``costmodel.StageCostModel``).
    # 0: one fabric joins every device, the reference's single-fabric
    # pricing
    devices_per_host: int = 0

    @property
    def ici_bw_total(self) -> float:
        return self.ici_bw * self.ici_links


# data sheet: an HGX H100 host joins 8 GPUs over NVLink
H100 = HardwareSpec(devices_per_host=8)
