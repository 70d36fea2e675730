"""whisper-base — enc-dec with conv audio frontend (stub). [arXiv:2212.04356]

6L d_model=512 8H (MHA kv=8) d_ff=2048 vocab=51865. The backbone is the
decoder (6L self+cross attn); the encoder is 6L over stubbed frame
embeddings (n_audio_ctx=1500, conv frontend provides precomputed frames
per the brief). Sinusoidal/learned positions replaced by RoPE on the
decoder for implementation uniformity (documented adaptation).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,       # decoder layers (the assigned backbone)
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab=51865,
        head_dim=64,
        enc_layers=6,
        n_audio_ctx=1500,
        n_mels=80,
        tie_embeddings=True,
    )
)
