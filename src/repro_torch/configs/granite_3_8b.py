"""Granite-3-8B [dense]: GQA kv=8.  [hf:ibm-granite/granite-3.0-8b-base]"""
from repro_torch.configs.base import ArchConfig, register

GRANITE_3_8B = register(ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    norm_type="rmsnorm",
    act="silu",
    mlp_gated=True,
    tie_embeddings=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
))
