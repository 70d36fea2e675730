"""Model configs and their registry: the dense and SSM families.

Every served architecture is a ``ModelConfig`` registered under its id;
``reduced()`` derives a CPU-testable config of the same family. The field
names and the reduce rule are those of the JAX package's ``configs/base.py``,
so a config built here names the same model there.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm (the families this package serves)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 = full attention
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # state-space (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # numerics
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"  # master params; serving casts to dtype

    # --- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 256 multiple (logits are sliced back to the
        true vocab)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        # the mamba2 conv covers the x, B and C streams
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    def layer_kinds(self) -> List[Tuple[str, str]]:
        """Per-layer (mixer, ffn) kinds: attn + mlp for the dense family,
        ssm + none for the SSM family (the mamba2 backbone has no separate
        FFN). Other families are not served yet."""
        if self.family == "dense":
            return [("attn", "mlp")] * self.n_layers
        if self.family == "ssm":
            return [("ssm", "none")] * self.n_layers
        raise NotImplementedError(
            f"{self.name}: family {self.family!r} is not served yet")

    def param_count(self) -> int:
        """Parameter count: the leaves of the weight tree (embeddings
        included), as the JAX package's count_params_analytical counts."""
        import math

        from repro_torch.models.params import leaves, model_defs

        return sum(math.prod(pd.shape) for _, pd in leaves(model_defs(self)))

    def active_param_count(self) -> int:
        return self.param_count()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}
_REDUCERS: Dict[str, Callable[[ModelConfig], ModelConfig]] = {}


def register(cfg: ModelConfig,
             reducer: Optional[Callable[[ModelConfig], ModelConfig]] = None) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    if reducer is not None:
        _REDUCERS[cfg.name] = reducer
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (ensure arch modules imported)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def _default_reduce(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduced config for CPU tests."""
    return replace(
        cfg,
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256,
        vocab=512,
        head_dim=32,
        sliding_window=16 if cfg.sliding_window else 0,
        **(dict(ssm_state=16, ssm_headdim=16, ssm_chunk=16) if cfg.ssm_state else {}),
    )


def reduced(name_or_cfg) -> ModelConfig:
    cfg = get_config(name_or_cfg) if isinstance(name_or_cfg, str) else name_or_cfg
    reducer = _REDUCERS.get(cfg.name, _default_reduce)
    return replace(reducer(cfg), name=cfg.name + "-reduced")
