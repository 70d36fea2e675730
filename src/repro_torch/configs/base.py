"""Model configs and their registry: the dense, MoE, SSM, hybrid,
encoder-decoder (audio) and vision-language families.

Every architecture is a ``ModelConfig`` registered under its id;
``reduced()`` derives a CPU-testable config of the same family. The field
names and the reduce rule are those of the JAX package's ``configs/base.py``,
so a config built here names the same model there.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 = full attention; >0 = SWA window (all attn layers)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # mixture-of-experts
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0            # per-expert ffn dim (0 -> d_ff)
    n_shared_experts: int = 0
    first_k_dense: int = 0       # leading dense (non-MoE) layers
    moe_every: int = 1           # MoE on layers where idx % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 4096   # tokens per dispatch group
    router_aux_weight: float = 0.01
    moe_impl: str = "einsum"     # einsum (GShard) | sort

    # state-space (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # hybrid (jamba): attention on layers where idx % attn_every == attn_offset
    attn_every: int = 0
    attn_offset: int = 0

    # encoder-decoder (whisper)
    enc_layers: int = 0
    n_audio_ctx: int = 0
    n_mels: int = 0

    # vision-language (phi-3-vision)
    n_img_tokens: int = 0

    # numerics
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"  # master params (train); serving casts to dtype
    remat: bool = True            # recompute each layer in the backward pass (train)

    # distribution (set by the train step's config, `core/steps._train_cfg`)
    attn_dp_axes: Tuple[str, ...] = ()  # attention on rows cut over these mesh axes

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
        """Per-layer (mixer, ffn) kinds: mixer in {attn, ssm}, ffn in {mlp,
        moe, none}. The SSM family is ssm + none (the mamba2 backbone has no
        separate FFN); the hybrid family puts attention on the layers
        `attn_every` and `attn_offset` pick and SSM on the rest; every
        other family is an attention stack. MoE sits on the layers
        `first_k_dense`, `moe_every` and `moe_offset` pick."""
        if self.family not in FAMILIES:
            raise NotImplementedError(
                f"{self.name}: no family {self.family!r} (known: {FAMILIES})")
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                kinds.append(("ssm", "none"))
                continue
            if self.family == "hybrid":
                mixer = ("attn" if self.attn_every and i % self.attn_every == self.attn_offset
                         else "ssm")
            else:
                mixer = "attn"
            moe = (self.n_experts and i >= self.first_k_dense
                   and i % self.moe_every == self.moe_offset)
            kinds.append((mixer, "moe" if moe else "mlp"))
        return kinds

    def is_subquadratic(self) -> bool:
        """True when long-context decode is in-family (SSM, hybrid or a
        window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Parameter count: the leaves of the weight tree (embeddings
        included), as the JAX package's count_params_analytical counts."""
        return self._count(active_only=False)

    def active_param_count(self) -> int:
        """Parameters a token reads: an expert leaf counts top_k / n_experts
        of its size (count_params_analytical(active_only=True))."""
        return self._count(active_only=True)

    def _count(self, active_only: bool) -> int:
        import math

        from repro_torch.models.params import leaves, model_defs

        total = 0
        for _, pd in leaves(model_defs(self)):
            n = math.prod(pd.shape)
            if active_only and pd.expert:
                n = int(n * self.top_k / self.n_experts)
            total += n
        return total


# ---------------------------------------------------------------------------
# Shape configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell is in-family: a 500k-token decode only
    for an arch whose long-context decode is subquadratic."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md)"
    return True, ""


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
    """Family-preserving reduced config for CPU tests (the JAX package's
    rule): a hybrid keeps 8 layers (one whole block of jamba's)."""
    changes = dict(
        n_layers=min(cfg.n_layers, 4) if cfg.family != "hybrid" else 8,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256,
        vocab=512,
        head_dim=32,
        moe_group_size=64,
    )
    if cfg.n_experts:
        changes.update(n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2),
                       moe_d_ff=128)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.sliding_window:
        changes.update(sliding_window=16)
    if cfg.enc_layers:
        changes.update(enc_layers=2, n_audio_ctx=24, n_mels=16)
    if cfg.n_img_tokens:
        changes.update(n_img_tokens=8)
    if cfg.first_k_dense:
        changes.update(first_k_dense=1)
    return replace(cfg, **changes)


def reduced(name_or_cfg) -> ModelConfig:
    cfg = get_config(name_or_cfg) if isinstance(name_or_cfg, str) else name_or_cfg
    reducer = _REDUCERS.get(cfg.name, _default_reduce)
    return replace(reducer(cfg), name=cfg.name + "-reduced")


def serve_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Head-padded config for tensor-parallel serving over `tp` ranks.

    When n_kv_heads < tp, KV heads are replicated rep = tp // n_kv_heads
    times (so the kv axis shards evenly) and q heads are re-factored and
    zero-padded into [kv_eff, g_eff] slots (`models/serve_pad.py`); the
    padded wo rows are zero, so the outputs are exact. Raises when tp is
    not a multiple of n_kv_heads."""
    if cfg.family == "ssm" or cfg.n_kv_heads % tp == 0 or tp <= 1:
        return cfg
    kh = cfg.n_kv_heads
    if tp % kh:
        raise ValueError(f"tp={tp} not a multiple of kv_heads={kh} for {cfg.name}")
    rep = tp // kh
    g = cfg.n_heads // kh
    g_eff = -(-g // rep)
    return replace(cfg, n_kv_heads=tp, n_heads=tp * g_eff)
