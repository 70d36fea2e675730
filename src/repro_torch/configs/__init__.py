"""Arch configs of the PyTorch package. Importing this package registers
them: MODEL_ARCHS, all ten of the JAX package's archs, run through the
model entry points (`models.api.LM`); SERVED_ARCHS, the nine the serving
engine admits. whisper-base is the tenth: its prefill needs
`audio_frames`, which the engine does not pass (nor does the JAX
package's), so it runs through `LM.prefill(..., audio_frames=)`,
`decode` and `generate` only."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_archs,
    reduced,
    register,
    serve_config,
    shape_applicable,
)

from repro_torch.configs import (  # noqa: F401
    granite_3_8b,
    h2o_danube_1_8b,
    jamba_v0_1_52b,
    mamba2_370m,
    mixtral_8x22b,
    moonshot_v1_16b_a3b,
    phi_3_vision_4_2b,
    tinyllama_1_1b,
    whisper_base,
    yi_34b,
)

SERVED_ARCHS = [
    "tinyllama-1.1b",
    "mamba2-370m",
    "h2o-danube-1.8b",
    "granite-3-8b",
    "yi-34b",
    "mixtral-8x22b",
    "moonshot-v1-16b-a3b",
    "jamba-v0.1-52b",
    "phi-3-vision-4.2b",
]

MODEL_ARCHS = SERVED_ARCHS + ["whisper-base"]
