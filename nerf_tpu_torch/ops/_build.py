"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ctypes. Libraries go to
``build/nerf_tpu_torch/`` at the repository root, named by a hash of the
source and the shared headers (``csrc/*.cuh``), so an edit rebuilds.
Nothing is built when a module is imported: the first launch on a CUDA
tensor builds; ``load_all`` builds several sources at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_tpu_torch"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: name -> (restype, argtypes)
SIGNATURES = {
    "fused_mlp_fwd": {
        "nerf_fused_mlp_fwd": (_I, [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
        "nerf_fused_mlp_fwd_points": (_I, [_I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
        "nerf_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "fused_mlp_bwd": {
        "nerf_fused_mlp_bwd_workspace": (_I, [_I, _I, _I, _I, ctypes.POINTER(_L)]),
        "nerf_fused_mlp_bwd": (
            _I,
            [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _L, _P, _P],
        ),
        "nerf_fused_mlp_bwd_points_workspace": (_I, [_I, _I, _I, _I, ctypes.POINTER(_L)]),
        "nerf_fused_mlp_bwd_points": (
            _I,
            [_I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _L, _P, _P, _P, _P],
        ),
        "nerf_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "fused_render": {
        "nerf_fused_render_fwd": (
            _I,
            [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
        ),
        "nerf_fused_render_bwd_planes": (_I, [_P] * 8 + [_I, _I, _I, _P, _P]),
        "nerf_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "probe_overlap": {
        "nerf_probe_overlap": (_I, [_I, _I, _I] + [_P] * 9),
        "nerf_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # source name -> nvcc/ptxas output of this process's build


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return nvcc


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def _build(names: Iterable[str]) -> None:
    """Compile the sources of ``names`` that are not built yet, one nvcc
    process per source, all running at once."""
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if name in procs or lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        src = CSRC / f"{name}.cu"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib, src)
    failed = []
    for name, (proc, tmp, lib, src) in procs.items():
        build_log[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{build_log[name]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """The ctypes libraries of ``csrc/<name>.cu`` for ``names``, building the
    missing ones in parallel."""
    names = list(names)
    _build(n for n in names if n not in _LIBS)
    for name in names:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
    return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    return load_all([name])[name]
