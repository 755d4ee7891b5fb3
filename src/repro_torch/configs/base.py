"""Architecture + shape configuration (a copy of ``repro/configs/base.py``).

Every architecture is a frozen ``ArchConfig``; ``reduced()`` yields the small
smoke-test variant of the same family (same code paths, tiny dims).  The
port registers only the architectures it can run (granite-3-8b,
qwen2-72b, qwen2-moe-a2.7b and zamba2-2.7b).  ``param_count`` is not copied: it
reaches the cost model, which has not been ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: (seq_len, global_batch) + which step it lowers."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}

# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention flavour
    attention_type: str = "gqa"  # gqa | mla
    qkv_bias: bool = False
    rope_theta: float = 10_000.0

    # MLA (MiniCPM3 / DeepSeek-V2 style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4

    # xLSTM
    xlstm_heads: int = 0

    # hybrid (Zamba2): one shared attention block applied every N backbone layers
    shared_attn_every: int = 0

    # enc-dec (Whisper backbone)
    encoder_layers: int = 0
    encoder_seq: int = 0

    # VLM (InternVL2): stubbed ViT frontend supplies patch embeddings
    num_patches: int = 0

    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu
    mlp_gated: bool = True  # SwiGLU-style gated MLP
    tie_embeddings: bool = False

    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # -- derived ------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def decoder_layers(self) -> int:
        return self.num_layers

    def shape_cells(self) -> Tuple[ShapeConfig, ...]:
        return tuple(SHAPES[s] for s in self.shapes)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4 if self.shared_attn_every == 0 else 8),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads * 4 // max(1, self.num_heads))),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.attention_type == "mla":
            kw.update(q_lora_rank=64, kv_lora_rank=32, qk_rope_head_dim=16,
                      qk_nope_head_dim=16, v_head_dim=32)
        if self.is_moe:
            kw.update(num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
                      num_shared_experts=min(1, self.num_shared_experts))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_expand=2)
        if self.xlstm_heads:
            kw.update(xlstm_heads=2)
        if self.shared_attn_every:
            kw.update(shared_attn_every=4)
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=64)
        if self.num_patches:
            kw.update(num_patches=16)
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (granite_3_8b,  # noqa: F401
                                     qwen2_72b, qwen2_moe_a2p7b,
                                     zamba2_2p7b)
