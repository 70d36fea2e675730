"""DPU Compute-Unit pipeline model (paper §4.2, Figs. 11-12).

A CU is an ordered pipeline of functional units (FUs); within a CU, FUs
stream block-granular data to each other, so a CU's latency for one request
is `sum(stage latencies)` but its *occupancy* (the interval before it can
accept the next request) is `max(stage latencies)` — the pipelining win of
Fig. 12(a).

The audio pipeline is split into TWO CU types (Fig. 11b): `Resample+Mel`
streams, but `Normalize` needs utterance-global mean/var, so fusing it would
serialize back-to-back requests exactly as in Fig. 12(b). Keeping it as a
separate CU restores pipelining across requests (Fig. 12(c)). The image
pipeline (decode -> resize -> crop -> normalize) is one CU: its dataflow is
sequential and streams cleanly (Fig. 12(a)).

Each FU carries a callable (numpy CPU baseline, or the Hopper kernels of
`repro_torch.kernels.ops` on a device) and an analytical cost model
(seconds per request as a function of input size) used by the virtual
clock; real execution just calls the function.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class FunctionalUnit:
    name: str
    fn: Callable[[Any], Any]
    cost_s: Callable[[Any], float]      # analytical per-request latency
    streaming: bool = True              # False => needs full input (Normalize)
    batch_fn: Optional[Callable[[List[Any]], List[Any]]] = None
    # batch_fn processes a stack of same-shape requests in ONE kernel launch
    # (DPU backend); None falls back to a per-request fn loop (CPU baseline).


@dataclass
class ComputeUnit:
    name: str
    units: List[FunctionalUnit]

    def process(self, x: Any) -> Any:
        for u in self.units:
            x = u.fn(x)
        return x

    def process_batch(self, xs: List[Any]) -> List[Any]:
        """Process a stack of same-shape requests through the CU. FUs with a
        batch_fn handle the whole stack in one kernel launch; the rest loop.
        """
        xs = list(xs)
        for u in self.units:
            if u.batch_fn is not None and len(xs) > 1:
                xs = list(u.batch_fn(xs))
            else:
                xs = [u.fn(x) for x in xs]
        return xs

    def latency_s(self, x: Any) -> float:
        """End-to-end single-request latency (sum of pipelined stages)."""
        return sum(u.cost_s(x) for u in self.units)

    def occupancy_s(self, x: Any) -> float:
        """Time before this CU can accept the next request.

        Streaming FUs pipeline => bounded by the slowest stage; a
        non-streaming FU (global stats) serializes the whole CU (Fig. 12b).
        """
        if any(not u.streaming for u in self.units):
            return self.latency_s(x)
        return max(u.cost_s(x) for u in self.units)


# ---------------------------------------------------------------------------
# Cost models (analytical; they drive the virtual clock, not a measurement)
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM data-sheet peaks: fp32 on the CUDA cores (the DPU kernels
# run fp32 FMA) at an assumed 30% efficiency for these small tiles, and the
# HBM3 bandwidth for the streaming stage.
_FP32_FLOPS = 67e12 * 0.3
_HBM_BYTES = 3.35e12
_FIXED_OVERHEAD = 20e-6     # assumed per-launch overhead
_IMG_OUT = 256              # the image CU resizes to 256 x 256 ...
_IMG_CROP = 224             # ... and center-crops 224 x 224


def _img_hw(x) -> Tuple[int, int]:
    """Pixel height and width of a raw JPEG payload ({"coeffs": [H/8, W/8,
    8, 8], ...}); 256 x 256 for a payload without coefficients."""
    if isinstance(x, dict) and "coeffs" in x:
        by, bx = x["coeffs"].shape[:2]
        return 8 * int(by), 8 * int(bx)
    return _IMG_OUT, _IMG_OUT


def _img_decode_cost(x) -> float:
    h, w = _img_hw(x)
    flops = h * w * 2 * 8 * 2          # two 8x8 products per block, 32 a pixel
    return flops / _FP32_FLOPS + _FIXED_OVERHEAD


def _img_resize_cost(x) -> float:
    # the two-tap kernel is bound by bytes: the image read once, the output
    # written once
    h, w = _img_hw(x)
    return (h * w + _IMG_OUT * _IMG_OUT) * 4 / _HBM_BYTES + _FIXED_OVERHEAD


def _img_crop_cost(x) -> float:
    return 0.0                         # a view: the normalize kernel reads it in place


def _img_norm_cost(x) -> float:
    return _IMG_CROP * _IMG_CROP * 4 * 2 / _HBM_BYTES + _FIXED_OVERHEAD


def _audio_resample_cost(x) -> float:
    n = _audio_len(x)
    return n * 48 * 2 / _FP32_FLOPS + _FIXED_OVERHEAD


def _audio_mel_cost(x) -> float:
    n = _audio_len(x)
    frames = max(1, n // 160)
    flops = frames * (512 * 514 * 2 + 257 * 80 * 2)
    return flops / _FP32_FLOPS + _FIXED_OVERHEAD


def _audio_norm_cost(x) -> float:
    n = _audio_len(x)
    frames = max(1, n // 160)
    return frames * 80 * 4 * 3 / _HBM_BYTES + _FIXED_OVERHEAD


def _audio_len(x) -> int:
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return x.shape[-1] if x.ndim == 1 else x.shape[0] * 160
    return int(x)


# ---------------------------------------------------------------------------
# CU factories
# ---------------------------------------------------------------------------


def make_image_cu(backend: str = "cpu",
                  device: Optional[torch.device] = None) -> ComputeUnit:
    """Single CU integrating all image FUs (sequential dataflow pipelines
    cleanly — paper Fig. 12a)."""
    ops = _image_ops(backend, device)
    return ComputeUnit(
        "image",
        [
            FunctionalUnit("decode", ops["decode"], _img_decode_cost,
                           batch_fn=ops.get("decode_batch")),
            FunctionalUnit("resize", ops["resize"], _img_resize_cost,
                           batch_fn=ops.get("resize_batch")),
            FunctionalUnit("crop", ops["crop"], _img_crop_cost,
                           batch_fn=ops.get("crop_batch")),
            FunctionalUnit("normalize", ops["normalize"], _img_norm_cost,
                           batch_fn=ops.get("normalize_batch")),
        ],
    )


def make_audio_cus(backend: str = "cpu",
                   device: Optional[torch.device] = None) -> Tuple[ComputeUnit, ComputeUnit]:
    """Two CU types (paper Fig. 11b): (Resample+Mel) and (Normalize)."""
    ops = _audio_ops(backend, device)
    cu_a = ComputeUnit(
        "audio_feat",
        [
            FunctionalUnit("resample", ops["resample"], _audio_resample_cost,
                           batch_fn=ops.get("resample_batch")),
            FunctionalUnit("mel", ops["mel"], _audio_mel_cost,
                           batch_fn=ops.get("mel_batch")),
        ],
    )
    cu_b = ComputeUnit(
        "audio_norm",
        [FunctionalUnit("normalize", ops["normalize"], _audio_norm_cost,
                        streaming=False, batch_fn=ops.get("normalize_batch"))],
    )
    return cu_a, cu_b


def make_audio_fused_cu(backend: str = "cpu",
                        device: Optional[torch.device] = None) -> ComputeUnit:
    """Single-CU audio design (paper Fig. 12b strawman; for the ablation)."""
    ops = _audio_ops(backend, device)
    return ComputeUnit(
        "audio_fused",
        [
            FunctionalUnit("resample", ops["resample"], _audio_resample_cost),
            FunctionalUnit("mel", ops["mel"], _audio_mel_cost),
            FunctionalUnit("normalize", ops["normalize"], _audio_norm_cost, streaming=False),
        ],
    )


def shared_qtable(payloads: List[Dict[str, Any]]) -> Optional[np.ndarray]:
    """The qtable every JPEG payload of a stack shares, or None when the
    tables differ. The IDCT kernel takes one table per launch, so only a
    stack with a shared table decodes in one launch."""
    qt = np.asarray(payloads[0]["qtable"])
    if all(np.array_equal(np.asarray(p["qtable"]), qt) for p in payloads[1:]):
        return qt
    return None


def _image_ops(backend: str, device: Optional[torch.device]) -> Dict[str, Callable]:
    """Per-request ops plus `*_batch` variants (DPU backend), as for audio
    below. A batched decode needs one shared qtable: a stack whose tables
    differ decodes request by request (one IDCT launch each), and the
    resize and normalize that follow still run once for the stack."""
    if backend == "dpu":
        from repro_torch.kernels import ops as kops

        def one(x):
            return torch.as_tensor(x).to(device)

        def stack(xs):
            return torch.stack([one(x) for x in xs])

        def decode_batch(cs):
            qt = shared_qtable(cs)
            if qt is None:
                return [kops.jpeg_decode(one(c["coeffs"]), one(c["qtable"])) for c in cs]
            return list(kops.jpeg_decode_batch(stack([c["coeffs"] for c in cs]), one(qt)))

        return {
            "decode": lambda c: kops.jpeg_decode(one(c["coeffs"]), one(c["qtable"])),
            "resize": lambda x: kops.image_resize(one(x), _IMG_OUT, _IMG_OUT),
            "crop": lambda x: kops.center_crop(one(x), _IMG_CROP, _IMG_CROP),
            "normalize": lambda x: kops.image_normalize(one(x), 127.5, 64.0).cpu().numpy(),
            "decode_batch": decode_batch,
            "resize_batch": lambda xs: list(
                kops.image_resize_batch(stack(xs), _IMG_OUT, _IMG_OUT)),
            "crop_batch": lambda xs: list(
                kops.center_crop_batch(stack(xs), _IMG_CROP, _IMG_CROP)),
            "normalize_batch": lambda xs: list(
                kops.image_normalize_batch(stack(xs), 127.5, 64.0).cpu().numpy()),
        }
    if backend != "cpu":
        raise ValueError(f"unknown DPU backend {backend!r}")
    from repro_torch.data import preprocess_cpu as pp

    return {
        "decode": lambda c: pp.decode_blocks(c["coeffs"], c["qtable"]),
        "resize": lambda x: pp.resize_bilinear(x, _IMG_OUT, _IMG_OUT),
        "crop": lambda x: pp.center_crop(x, _IMG_CROP, _IMG_CROP),
        "normalize": lambda x: pp.normalize_image(x, 127.5, 64.0),
    }


def _audio_ops(backend: str, device: Optional[torch.device]) -> Dict[str, Callable]:
    """Per-request ops plus `*_batch` variants (DPU backend): a batch op
    takes/returns a list of same-shape requests and runs the whole stack in
    one kernel launch, on `device`. Intermediate results stay on the device;
    the last FU (normalize) copies its features to the host. The CPU
    baseline intentionally has no batch ops — host cores run one request per
    core (the paper's preprocessing wall)."""
    if backend == "dpu":
        from repro_torch.kernels import ops as kops

        def stack(xs):
            return torch.stack([torch.as_tensor(x).to(device) for x in xs])

        def one(x):
            return torch.as_tensor(x).to(device)

        return {
            "resample": lambda x: kops.audio_resample(one(x), 1, 3),
            "mel": lambda x: kops.mel_spectrogram(one(x)),
            "normalize": lambda x: kops.audio_normalize(one(x)).cpu().numpy(),
            "resample_batch": lambda xs: list(
                kops.audio_resample_batch(stack(xs), 1, 3)),
            "mel_batch": lambda xs: list(kops.mel_spectrogram_batch(stack(xs))),
            "normalize_batch": lambda xs: list(
                kops.audio_normalize_batch(stack(xs)).cpu().numpy()),
        }
    if backend != "cpu":
        raise ValueError(f"unknown DPU backend {backend!r}")
    from repro_torch.data import preprocess_cpu as pp

    return {
        "resample": lambda x: pp.resample_poly(x, 1, 3),
        "mel": pp.mel_spectrogram,
        "normalize": pp.normalize_meanvar,
    }
