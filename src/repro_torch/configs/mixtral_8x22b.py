"""mixtral-8x22b — 8-expert top-2 MoE with SWA. [arXiv:2401.04088; hf]

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,       # per-expert ffn dim
        vocab=32768,
        head_dim=128,
        sliding_window=4096,
        moe_group_size=2048,
        n_experts=8,
        top_k=2,
        rope_theta=1_000_000.0,
    )
)
