"""The wide family's device time split by kernel, on the card: K1w on one
32,768-ray serving chunk (64 and 192 samples) and K4w on one N_rand 4096
training step (64 and 192 samples), W = 512 with 10 / 4 octaves, bf16,
seed-7 weights, each profiled over REPS calls after a warm-up.

    python -m nerf_tpu_torch.tools.wide_split

prints one JSON line: the card (name, power limit), and for K1w and K4w
the device ms a call of each of the family's kernels (``KERNELS``, matched
by name in the profile), of any other kernel, their sum and the GEMM's
share of it; and each of K4w's two weight-grad launches' cluster size,
grid and problem count (``wgrad_launches``, ``wgrad_check.last_launch``).
The tool imports only ``nerf_tpu_torch``; run as a file with another
checkout's root on ``PYTHONPATH`` it profiles that checkout's kernels, so
two builds compare in one call (tools/fwd_time.py does the same).
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import _build, fused_mlp
from nerf_tpu_torch.tools.wgrad_check import last_launch

CHUNK, N_RAND, WIDTH = 32 * 1024, 4096, 512
LEVELS = (64, 192)
KERNELS = ("gemm_bf16_sm90", "embed_cols", "head_cols", "gc_rows", "ray_sums", "wgrad_bf16",
           "reduce_splits", "reduce_tiles")
REPS = 3


def _rays(rng: np.random.Generator, R: int, S: int, dev):
    ro = rng.standard_normal((R, 3)).astype(np.float32)
    ro = 4 * ro / np.linalg.norm(ro, axis=-1, keepdims=True)
    rd = (-ro / 4 + 0.3 * rng.standard_normal((R, 3))).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (R, S)).astype(np.float32), -1)
    return [torch.from_numpy(a).to(dev) for a in (ro, rd, vd, z)]


def _device_us(event) -> float:
    for key in ("device_time_total", "cuda_time_total"):
        v = getattr(event, key, None)
        if v:
            return float(v)
    return 0.0


def split(calls) -> dict:
    """Device ms a round of ``calls`` (each run REPS times under the
    profiler after one warm-up round), by the family's kernel names."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(KERNELS + ("other",), 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in KERNELS if k in e.key), "other")
        ms[name] += _device_us(e) / 1e3 / REPS
    total = sum(ms.values())
    if total <= 0:
        raise RuntimeError("the profile holds no device time")
    return {**{k: round(v, 4) for k, v in ms.items()}, "total": round(total, 4),
            "gemm_share": round(ms["gemm_bf16_sm90"] / total, 4)}


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        print("wide_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    mlp = NeRFMLP(MLPConfig(width=WIDTH), seed=7, device=dev)
    kp, blobs = fused_mlp.packed_params(mlp, PosEncConfig(10), PosEncConfig(4), torch.bfloat16)
    if not fused_mlp.is_wide(kp):
        raise RuntimeError("W = 512 is not a wide configuration")
    rng = np.random.default_rng(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    chunk = [_rays(rng, CHUNK, S, dev) for S in LEVELS]
    fwd = [lambda r=r: fused_mlp.fused_rays_planes(kp, *r, blobs) for r in chunk]
    res = {"card": smi, "K1w_per_chunk": split(fwd)}
    del chunk, fwd
    torch.cuda.empty_cache()
    step = [_rays(rng, N_RAND, S, dev) for S in LEVELS]
    gs = [torch.rand(4, N_RAND, S, device=dev) * 1e-4 for S in LEVELS]
    bwd = [lambda r=r, g=g: fused_mlp.fused_rays_planes_bwd(kp, *r, g, blobs)
           for r, g in zip(step, gs)]
    res["K4w_per_step"] = split(bwd)
    res["wgrad_launches"] = []
    for fn in bwd:
        fn()
        res["wgrad_launches"].append(last_launch(_build.load("fused_mlp_wide")))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
