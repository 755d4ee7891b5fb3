"""Zamba2-2.7B [hybrid]: Mamba2 backbone + shared attention block.  [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig, register

ZAMBA2_2P7B = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    shared_attn_every=6,       # one shared full-attn+MLP block applied every 6 layers
    norm_type="rmsnorm",
    act="gelu",
    mlp_gated=True,
    # hybrid/SSM: sub-quadratic decode -> long_500k applies
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
))
