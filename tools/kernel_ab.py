#!/usr/bin/env python3
"""Time the resample path, audio normalize and crop-normalize of source trees
in turns on one NVIDIA GPU, so that two versions of the kernels are
compared on one card.

    python3 tools/kernel_ab.py [--out PATH] LABEL=TREE [LABEL=TREE ...]

Each TREE is the root of a checkout (its `src/` holds `repro_torch`); give
one tree several times to run it in turns with another (A, B, B, A). For
each, in the order given, a fresh process imports that tree's package,
builds its kernels into the tree's own `build/kernels/`, and times, as
chip_smoke.py does (CUDA events, each call queued behind a spin kernel,
median of 25 after warm-up; cold: each sample behind a 128 MB write that
flushes the 50 MB L2):

- path_ms: `ops.audio_resample_batch(x, 1, 3)` on an unpadded stack, the
  serve path's whole call, at chip_smoke.py's phase-3 shapes;
- kernel_ms, kernel_cold_ms: the resample kernel alone on what that tree's
  path hands it: the unpadded stack with pad_left where the tree's kernel
  takes one, else the stack padded beforehand (72 zeros left, 144 right);
- audio normalize on that tree's log-mel features of the same stacks
  (T = 98, 398, 2,998 frames) and of 10, 12.5, 15 and 20 s stacks at
  N in {1, 16} (T = 998, 1,248, 1,498, 1,998): the kernel warm and cold,
  with its cluster size where the tree's kernel has a plan, and path_ms,
  the serve path's `ops.audio_normalize_batch`;
- crop-normalize warm and cold, 256 x 256 -> 224 x 224 at N in {1, 4, 16}
  (the stacks of chip_smoke.py's image phase: every image row crops a
  resized 256 x 256 stack);
- floor_ms: a 1-element fill, the launch floor.

Each run prints one JSON line; with --out all runs are written to PATH.
Exits non-zero without a CUDA device.

To compare normalize's cluster sizes, give trees whose
`src/repro_torch/kernels/csrc/audio_normalize.cu` differ only in
`kLongRows`, the T from which 8 blocks take an utterance instead of 4
(1: 8 blocks at every T >= 8; a large value: 4 blocks at every T >= 4):
copy the tree's `src/` into `build/c8/src/` and edit it there.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CROP_N = (1, 4, 16)
NORM_SHAPES = ((1, 480_000), (16, 480_000), (1, 600_000), (16, 600_000),
               (1, 720_000), (16, 720_000), (1, 960_000), (16, 960_000))


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import audio_normalize as kn
    from repro_torch.kernels import audio_resample as kr
    from repro_torch.kernels import image_normalize as kin
    from repro_torch.kernels import ops

    if not Path(repro_torch.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"imported {repro_torch.__file__}, not the tree {tree}")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(cs.L2_FLUSH_FLOATS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    h = ops.resample_taps(1, 3, 48, dev)
    taps = h.shape[0]
    takes_pad = "pad_left" in inspect.signature(kr.audio_resample_batch_kernel).parameters
    rows = []
    for n, length in cs.SHAPES:
        x = torch.randn((n, length), generator=gen, device=dev)
        n_out = (length + 2) // 3
        if takes_pad:
            def kernel():
                return kr.audio_resample_batch_kernel(x, h, 3, n_out, taps // 2)
        else:
            xp = F.pad(x, (taps // 2, taps)).contiguous()

            def kernel():
                return kr.audio_resample_batch_kernel(xp, h, 3, n_out)
        path = ops.audio_resample_batch(x, 1, 3)
        if not torch.equal(kernel(), path):
            raise SystemExit(f"resample at N={n} L={length}: the path and the kernel differ")
        rows.append(dict(
            name="audio_resample", n=n, L=length,
            path_ms=cs.time_ms(torch, lambda: ops.audio_resample_batch(x, 1, 3)),
            kernel_ms=cs.time_ms(torch, kernel),
            kernel_cold_ms=cs.time_ms(torch, kernel, flush=flush)))
        feats = ops.mel_spectrogram_batch(path)
        rows.append(normalize_row(torch, cs, kn, ops, feats, n, length, flush))
    for n, length in NORM_SHAPES:
        x = torch.randn((n, length), generator=gen, device=dev)
        feats = ops.mel_spectrogram_batch(ops.audio_resample_batch(x, 1, 3))
        rows.append(normalize_row(torch, cs, kn, ops, feats, n, length, flush))
    for n in CROP_N:
        z = torch.rand((n, 256, 256), generator=gen, device=dev) * 255

        def crop():
            return kin.image_crop_normalize_batch_kernel(z, 224, 224, 127.5, 64.0)

        if not torch.equal(crop(), kin.image_crop_normalize_batch_plain(z, 224, 224, 127.5, 64.0)):
            raise SystemExit(f"crop-normalize at N={n}: not bit for bit its plain version")
        rows.append(dict(name="image_normalize", n=n, H=256, W=256,
                         ms=cs.time_ms(torch, crop),
                         cold_ms=cs.time_ms(torch, crop, flush=flush)))
    tiny = torch.zeros(1, device=dev)
    return {"tree": str(tree), "card": cs.card_line(), "kernel_takes_pad_left": takes_pad,
            "floor_ms": cs.time_ms(torch, tiny.zero_), "rows": rows}


def normalize_row(torch, cs, kn, ops, feats, n: int, length: int, flush) -> dict:
    """Audio normalize on one stack of features: the serve path's call and
    the kernel, warm and cold."""
    t = feats.shape[1]
    row = dict(name="audio_normalize", n=n, L=length, T=t)
    if hasattr(kn, "plan"):
        row["cluster"] = kn.plan(t, feats.shape[2]).cluster

    def kernel():
        return kn.audio_normalize_batch_kernel(feats)

    err = float((kernel() - ops.audio_normalize_batch(feats)).abs().max())
    if err > 3e-3:
        raise SystemExit(f"normalize at N={n} L={length}: {err} from the path")
    row["path_ms"] = cs.time_ms(torch, lambda: ops.audio_normalize_batch(feats))
    row["kernel_ms"] = cs.time_ms(torch, kernel)
    row["kernel_cold_ms"] = cs.time_ms(torch, kernel, flush=flush)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="write every run here (JSON)")
    ap.add_argument("--one", default="", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="*", help="LABEL=TREE, in the order to run them")
    args = ap.parse_args()
    if args.one:
        import torch

        if not torch.cuda.is_available():
            print("kernel_ab: CUDA is not available", file=sys.stderr)
            return 1
        print(json.dumps(measure(Path(args.one))))
        return 0
    runs = []
    for spec in args.trees:
        label, _, tree = spec.partition("=")
        out = subprocess.run([sys.executable, __file__, "--one", tree], check=True,
                             stdout=subprocess.PIPE, text=True).stdout
        run = dict(json.loads(out.strip().splitlines()[-1]), label=label)
        print(json.dumps(run), flush=True)
        runs.append(run)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
