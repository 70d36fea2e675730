"""granite-3-8b — GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
Granite's embedding/residual/logit multipliers are omitted, as in the JAX
package's config: plain llama-style GQA with the listed dims.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab=49155,
        head_dim=128,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
)
