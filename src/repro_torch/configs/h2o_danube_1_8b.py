"""h2o-danube-1.8b — llama+mistral mix with SWA. [arXiv:2401.16818; hf]

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding-window attn.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab=32000,
        head_dim=80,
        sliding_window=4096,  # mistral-style SWA
        rope_theta=10_000.0,
    )
)
