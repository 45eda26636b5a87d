"""ctypes binding for the host image resampler (``resize.cpp``): the area
block mean and Lanczos-3, the LLFF loader's minify step.

Counterpart of nerf_tpu/native/resize.py. The library is built with ``g++``
at first use into ``build/nerf_tpu_torch/`` (beside the CUDA kernels of
``ops/_build.py``), named by a hash of the source and the flags, which are
nerf_tpu's, so both libraries compute the same sums. A failed build raises:
there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from nerf_tpu_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "resize.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
_lock = threading.Lock()
_lib = None


def build(src: Path = SRC) -> Path:
    """The shared library of ``src``, compiled unless already built; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    src = Path(src)
    if not src.exists():
        raise RuntimeError(f"cannot build the image resampler: {src} does not exist")
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {src}: g++ is not installed") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, in_t in (
                ("area_downsample_u8", ctypes.c_uint8),
                ("area_downsample_f32", ctypes.c_float),
            ):
                fn = getattr(lib, name)
                fn.argtypes = [
                    ctypes.POINTER(in_t),
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_float),
                ]
                fn.restype = None
            lib.lanczos_resize_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.lanczos_resize_f32.restype = None
            _lib = lib
    return _lib


def area_downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Block-mean downsample ``img`` [H, W, C] (or [H, W]) by an integer
    factor, trailing rows and columns that fill no block dropped.

    uint8 input -> float32 in [0, 255]; float input -> float32, same scale.
    """
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    lib = _load()
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    out = np.empty((H // factor, W // factor, C), np.float32)
    if img.dtype == np.uint8:
        src = np.ascontiguousarray(img)
        lib.area_downsample_u8(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            H, W, C, factor,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    else:
        src = np.ascontiguousarray(img, dtype=np.float32)
        lib.area_downsample_f32(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            H, W, C, factor,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    return out[..., 0] if squeeze else out


def lanczos_resize(img: np.ndarray, H2: int, W2: int) -> np.ndarray:
    """Lanczos-3 resample ``img`` [H, W, C] (or [H, W]) to (H2, W2): the
    filter ImageMagick's ``-resize`` uses when minifying (ref
    load_llff.py:45). Output float32 in the input's scale, not clamped
    (Lanczos overshoots; callers clip)."""
    if H2 < 1 or W2 < 1:
        raise ValueError(f"target size must be positive, got {H2}x{W2}")
    lib = _load()
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    src = np.ascontiguousarray(img, dtype=np.float32)
    out = np.empty((H2, W2, C), np.float32)
    lib.lanczos_resize_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        H, W, C, H2, W2,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out[..., 0] if squeeze else out
