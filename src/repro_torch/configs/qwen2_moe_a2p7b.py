"""Qwen2-MoE-A2.7B [moe]: 60 routed top-4 + 4 shared experts.  [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.configs.base import ArchConfig, register

QWEN2_MOE_A2P7B = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,             # routed-expert hidden dim per assignment
    vocab_size=151936,
    qkv_bias=True,
    num_experts=60,
    num_experts_per_tok=4,
    num_shared_experts=4,  # shared path = 4 x 1408 = 5632 hidden
    moe_d_ff=1408,
    norm_type="rmsnorm",
    act="silu",
    mlp_gated=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
))
