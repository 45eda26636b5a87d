"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ctypes. Libraries go to
``build/nerf_tpu_torch/`` at the repository root, named by a hash of the
source and the shared headers (``csrc/*.cuh``), so an edit rebuilds; each
keeps nvcc's output (ptxas's ``-v`` report of registers and spills) beside
it as ``.log``, and a library without its log is built again.
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
        "nerf_fused_mlp_fwd_stacked": (_I, [_I, _I] + [_P] * 4 + [_I] * 5 + [_P] * 4),
        "nerf_fused_mlp_fwd_points_stacked": (_I, [_I, _I, _P, _P] + [_I] * 5 + [_P] * 4),
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
        "nerf_fused_mlp_bwd_recompute": (
            _I, [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
        ),
        "nerf_fused_mlp_bwd_recompute_points": (
            _I, [_I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
        ),
        "nerf_fused_mlp_bwd_recompute_points_stacked": (
            _I, [_I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
        ),
        "nerf_fused_mlp_bwd_chain": (_I, [_I] + [_P] * 5 + [_I] * 4 + [_P] * 8),
        "nerf_fused_mlp_bwd_stacked_workspace": (_I, [_I] * 5 + [ctypes.POINTER(_L)]),
        "nerf_fused_mlp_bwd_stacked": (
            _I, [_I, _I] + [_P] * 5 + [_I] * 5 + [_P] * 4 + [_L, _P, _P],
        ),
        "nerf_fused_mlp_bwd_chain_points": (_I, [_I] + [_P] * 3 + [_I] * 4 + [_P] * 10),
        "nerf_fused_mlp_bwd_points_stacked_workspace": (_I, [_I] * 5 + [ctypes.POINTER(_L)]),
        "nerf_fused_mlp_bwd_points_stacked": (
            _I, [_I, _I] + [_P] * 3 + [_I] * 5 + [_P] * 4 + [_L, _P, _P],
        ),
        "nerf_wgrad_last_launch": (None, [_P]),
        "nerf_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "fused_render": {
        "nerf_fused_render_fwd": (
            _I,
            [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _L,
             _P],
        ),
        "nerf_fused_render_fwd_stacked": (_I, [_I, _I] + [_P] * 5 + [_I] * 6 + [_P] * 8 + [_L, _P]),
        "nerf_fused_render_bwd_planes": (_I, [_P] * 8 + [_I, _I, _I, _P, _P]),
        "nerf_fused_render_composite": (_I, [_P] * 4 + [_I] * 3 + [_P] * 5),
        "nerf_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "fused_mlp_wide": {
        "nerf_wide_embed": (_I, [_I, _I] + [_P] * 4 + [_I] * 4 + [_P, _L, _I, _P]),
        "nerf_wide_gemm": (
            _I, [_I, _I, _I, _I, _P, _L, _L, _I, _P, _L, _P, _L, _L, _I, _P, _L, _P, _L, _P, _L,
                 _L, _I, _P, _L, _I, _P, _L, _P, _L, _P, _L, _P],
        ),
        "nerf_wide_head": (_I, [_I, _P, _P, _L, _I, _I, _I, _P, _L, _P, _L, _P, _L, _L, _P]),
        "nerf_wide_gc": (_I, [_I, _P, _L, _L, _I, _I, _P, _L, _P, _L, _P]),
        "nerf_wide_ray_sums": (_I, [_I, _P, _L, _I, _I, _I, _P, _L, _I, _P]),
        "nerf_wide_embed_bwd": (_I, [_P, _I, _I, _P, _L, _P, _P]),
        "nerf_wide_wgrad": (
            _I, [_I, _P, _I, _L, _P, _I, _L, _I, _I, _P, _I, _I, _L, _P, _P, _P, _I, _I, _P],
        ),
        "nerf_wide_wgrad_slots": (_I, [_I, ctypes.POINTER(_I)]),
        "nerf_wgrad_last_launch": (None, [_P]),
        "nerf_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "probe_overlap": {
        "nerf_probe_overlap": (_I, [_I, _I, _I] + [_P] * 9),
        "nerf_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


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


def build_log(name: str) -> str:
    """nvcc's output for the built library of ``csrc/<name>.cu``, ptxas's
    register and spill report included (empty before the first build)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _build(names: Iterable[str]) -> None:
    """Compile the sources of ``names`` that are not built yet, one nvcc
    process per source, all running at once."""
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if name in procs or (lib.exists() and lib.with_suffix(".log").exists()):
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        src = CSRC / f"{name}.cu"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib, src)
    failed = []
    for name, (proc, tmp, lib, src) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
        else:
            tmp.with_suffix(".log").write_text(log)
            os.replace(tmp.with_suffix(".log"), lib.with_suffix(".log"))
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
