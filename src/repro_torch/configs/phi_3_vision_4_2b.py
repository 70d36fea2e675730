"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (stub).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

32L d_model=3072 32H (kv=32, i.e. MHA) d_ff=8192 vocab=32064. The CLIP
vision tower is a stub: input_specs() provides precomputed patch
embeddings (n_img_tokens x d_model) merged into the token stream.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32064,
        head_dim=96,
        n_img_tokens=576,
        rope_theta=10_000.0,
    )
)
