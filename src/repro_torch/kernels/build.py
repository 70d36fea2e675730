"""Build and load the hand-written kernels (the DPU's and decode attention):
nvcc -> one shared library -> ctypes.

The CUDA sources under `csrc/` are compiled for Hopper (`sm_90a`) at first
use, into `build/kernels/` at the root of the checkout: one `nvcc -c` per
source, all started together, then one link into a shared library with a
plain C interface. The library's name carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Importing this module builds nothing; a machine without `nvcc` can import
every module of the package and use the kernels' plain versions on the CPU.
A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("audio_resample.cu", "mel_spectrogram.cu", "audio_normalize.cu",
           "jpeg_idct.cu", "image_resize.cu", "image_normalize.cu",
           "decode_attention.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # name: (argtypes, restype)
    "preba_resample": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
    "preba_resample_smem_bytes": ([_I, _I, _I, _I], _I),
    "preba_mel": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "preba_mel_max_mels": ([], _I),
    "preba_normalize": ([_P, _P, _I, _I, _I, ctypes.c_float, _P], _I),
    "preba_normalize_plan": ([_I, _I, _IP, _IP, _IP], _I),
    "preba_normalize_vectorized": ([_P, _P, _I], _I),
    "preba_idct": ([_P, _P, _P, _P, _I, _I, _P], _I),
    "preba_resize": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "preba_crop_normalize": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                              ctypes.c_float, _P], _I),
    "preba_crop_normalize_vectorized": ([_P, _P, _I, _I, _I], _I),
    "preba_decode_attention": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                ctypes.c_float, _P], _I),
    "preba_decode_attention_smem_bytes": ([_I, _I, _I], _I),
    "preba_decode_attention_max_clusters": ([_I, _I, _I, _I, _I], _I),
    "preba_error_string": ([_I], ctypes.c_char_p),
}

_lib: Optional[ctypes.CDLL] = None
ptxas_log: str = ""  # nvcc/ptxas output of this process's build ("" if it loaded a built one)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the DPU kernels are built from source at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libpreba_dpu_{_digest()}.so"


def _run_all(cmds: List[List[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs, failed = [], []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("DPU kernel build failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> Path:
    """Compile the sources into the shared library unless it already exists
    for these exact sources and flags. Returns its path."""
    global ptxas_log
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                    for s, o in zip(SOURCES, objs)])
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    log += _run_all([[nvcc, "-shared", *NVCC_FLAGS[:2], *(str(o) for o in objs),
                      "-o", str(tmp)]])
    os.replace(tmp, so)
    for o in objs:
        o.unlink(missing_ok=True)
    ptxas_log = log
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (launch refused, bad config)."""
    if err != 0:
        msg = library().preba_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err} ({msg})")
