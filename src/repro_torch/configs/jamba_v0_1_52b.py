"""jamba-v0.1-52b — Mamba+attention 1:7 interleave with MoE. [arXiv:2403.19887]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Layout: every 8-layer block has 1 attention layer (idx%8==0 here) and 7
SSM layers; MoE on every other layer (idx%2==1). SSM blocks use Mamba2-SSD
(state 128) as the framework's SSM substrate (DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=65536,
        head_dim=128,
        moe_group_size=2048,
        n_experts=16,
        top_k=2,
        moe_every=2,
        moe_offset=1,
        attn_every=8,
        attn_offset=0,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_conv=4,
    )
)
