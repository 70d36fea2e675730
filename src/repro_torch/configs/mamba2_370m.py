"""mamba2-370m — SSD (state-space duality), attention-free. [arXiv:2405.21060]

48L d_model=1024 d_ff=0 vocab=50280, ssm_state=128, expand=2, headdim=64.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=16,      # unused (attention-free); kept for uniform API
        n_kv_heads=16,
        d_ff=0,
        vocab=50280,
        head_dim=64,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_conv=4,
        tie_embeddings=True,
    )
)
