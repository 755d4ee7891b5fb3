"""Qwen2-72B [dense]: GQA kv=8, QKV bias.  [arXiv:2407.10671]"""
from repro_torch.configs.base import ArchConfig, register

QWEN2_72B = register(ArchConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    act="silu",
    mlp_gated=True,
    # pure full attention -> long_500k skipped (see DESIGN.md §4)
    shapes=("train_4k", "prefill_32k", "decode_32k"),
))
