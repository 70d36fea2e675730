"""Arch configs served by the PyTorch package. Importing this package
registers them."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    list_archs,
    reduced,
    register,
)

from repro_torch.configs import mamba2_370m, tinyllama_1_1b  # noqa: F401

SERVED_ARCHS = ["tinyllama-1.1b", "mamba2-370m"]
