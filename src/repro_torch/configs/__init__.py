"""Arch configs served by the PyTorch package. Importing this package
registers them."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    list_archs,
    reduced,
    register,
)

from repro_torch.configs import (  # noqa: F401
    granite_3_8b,
    h2o_danube_1_8b,
    mamba2_370m,
    mixtral_8x22b,
    moonshot_v1_16b_a3b,
    tinyllama_1_1b,
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
]
