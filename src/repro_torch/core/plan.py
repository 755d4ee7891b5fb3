"""Training/serving plan (a copy of ``repro/core/plan.py``).

Per pipeline stage i the knobs are (L_i, b_i, DP_i, TP_i, ZeRO_i, CKPT_i,
WO_i, GO_i, OO_i, AO_i), plus global gradient-accumulation steps G and the
number of stages S.  The JSON form is byte-identical to the reference's, so
a plan tuned by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class KernelConfig:
    """Per-op kernel tile/block sizes: the reference's fields and defaults.

    What a tuple means on Hopper (``kernels/tiles.py``, docs/port.md "Plan
    tiles and Hopper tiles"): a field at its default runs the tile its
    kernel always ran (128 query rows an item, K/V tiles and backward blocks
    of 128 keys, 8 RMSNorm rows a block, chunk 256); any other value must
    be an entry of the Hopper menu (``tiles.MENU``: K/V tiles of 64 or 128
    keys, 8 rows a block), which the kernel then runs; anything else
    raises before a launch.  ``ssd_chunk`` is the chunk on every route.  On
    the CPU the plain versions take the values as the reference does."""
    attn_q_block: int = 512     # flash-attention query tile (rows)
    attn_kv_block: int = 512    # flash-attention key/value tile (cols)
    rmsnorm_block: int = 256    # rmsnorm row-block
    ssd_chunk: int = 256        # ssd_scan intra-chunk length

    def replace(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)

    def astuple(self) -> Tuple[int, int, int, int]:
        return (self.attn_q_block, self.attn_kv_block, self.rmsnorm_block,
                self.ssd_chunk)


DEFAULT_KERNEL_CONFIG = KernelConfig()


@dataclass(frozen=True)
class StageConfig:
    layers: int                 # L_i
    micro_batch: int            # b_i (per data-parallel replica)
    dp: int                     # DP_i
    tp: int                     # TP_i
    zero: int = 1               # ZeRO_i in {0,1,2,3}
    ckpt_layers: int = 10**9    # CKPT_i (clamped to L_i)
    wo: float = 0.0             # weight (master) offload ratio
    go: float = 0.0             # gradient-accumulator offload ratio
    oo: float = 0.0             # optimizer-state offload ratio
    ao: float = 0.0             # activation offload ratio

    @property
    def devices(self) -> int:
        return self.dp * self.tp

    def replace(self, **kw) -> "StageConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Plan:
    grad_accum: int             # G
    stages: Tuple[StageConfig, ...]
    sequence_parallel: bool = True
    remat_policy: str = "full"  # full | dots
    attn_impl: str = "naive"    # naive | blocked | pallas (FlashAttention)
    use_pallas: bool = False
    grad_compression: bool = False
    kv_cache_dtype: str = "bf16"    # bf16 | int8
    kernel: KernelConfig = DEFAULT_KERNEL_CONFIG
    page_size: int = 0  # paged-KV page size in tokens; 0 = contiguous cache

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def devices(self) -> int:
        return sum(s.devices for s in self.stages)

    @property
    def total_layers(self) -> int:
        return sum(s.layers for s in self.stages)

    def global_batch(self) -> int:
        s0 = self.stages[0]
        return self.grad_accum * s0.micro_batch * s0.dp

    def replace(self, **kw) -> "Plan":
        return dataclasses.replace(self, **kw)

    # -- (de)serialization ----------------------------------------------------
    def to_json(self) -> str:
        doc = {
            "grad_accum": self.grad_accum,
            "sequence_parallel": self.sequence_parallel,
            "remat_policy": self.remat_policy,
            "attn_impl": self.attn_impl,
            "use_pallas": self.use_pallas,
            "grad_compression": self.grad_compression,
            "kv_cache_dtype": self.kv_cache_dtype,
        }
        # omitted at the defaults, as in the reference
        if self.kernel != DEFAULT_KERNEL_CONFIG:
            doc["kernel"] = dataclasses.asdict(self.kernel)
        if self.page_size:
            doc["page_size"] = self.page_size
        doc["stages"] = [dataclasses.asdict(s) for s in self.stages]
        return json.dumps(doc, indent=2)

    @staticmethod
    def from_json(text: str) -> "Plan":
        d = json.loads(text)
        stages = tuple(StageConfig(**s) for s in d.pop("stages"))
        kernel = KernelConfig(**d.pop("kernel")) if "kernel" in d \
            else DEFAULT_KERNEL_CONFIG
        return Plan(stages=stages, kernel=kernel, **d)


def single_stage_plan(num_layers: int, *, dp: int, tp: int, micro_batch: int,
                      grad_accum: int, zero: int = 1,
                      ckpt_layers: Optional[int] = None, wo=0.0, go=0.0,
                      oo=0.0, ao=0.0, **plan_kw) -> Plan:
    """Convenience: the no-pipeline plan (S=1)."""
    st = StageConfig(layers=num_layers, micro_batch=micro_batch, dp=dp, tp=tp,
                     zero=zero,
                     ckpt_layers=num_layers if ckpt_layers is None
                     else ckpt_layers,
                     wo=wo, go=go, oo=oo, ao=ao)
    return Plan(grad_accum=grad_accum, stages=(st,), **plan_kw)
