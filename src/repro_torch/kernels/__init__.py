"""The hand-written CUDA kernels for Hopper (the DPU's functional units and
decode attention), each with its plain PyTorch version beside it and a
count of its launches."""
from typing import Dict

from repro_torch.kernels import (audio_normalize, audio_resample, decode_attention,
                                 image_normalize, image_resize, jpeg_idct,
                                 mel_spectrogram)

_MODULES = {
    "audio_resample": audio_resample,
    "mel_spectrogram": mel_spectrogram,
    "audio_normalize": audio_normalize,
    "jpeg_idct": jpeg_idct,
    "image_resize": image_resize,
    "image_normalize": image_normalize,
    "decode_attention": decode_attention,
}
KERNELS = tuple(_MODULES)
AUDIO_KERNELS = ("audio_resample", "mel_spectrogram", "audio_normalize")
IMAGE_KERNELS = ("jpeg_idct", "image_resize", "image_normalize")


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset (process-wide)."""
    return {name: mod.LAUNCHES for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.LAUNCHES = 0
