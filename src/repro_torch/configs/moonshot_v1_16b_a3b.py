"""moonshot-v1-16b-a3b — kimi/moonlight fine-grained MoE, 64e top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]

48L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=163840, 64e top-6.
DeepSeek-V3-style defaults, as in the JAX package's config: 1 leading dense layer
(dense d_ff=11264) + 2 shared experts. The listed 48L governs (real
Moonlight has 27L); N is computed from the actual parameter tree.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=11264,        # dense-layer ffn dim (first_k_dense layers)
        vocab=163840,
        head_dim=128,
        moe_group_size=1024,
        n_experts=64,
        top_k=6,
        moe_d_ff=1408,     # per-expert ffn dim
        n_shared_experts=2,
        first_k_dense=1,
        rope_theta=50_000.0,
    )
)
