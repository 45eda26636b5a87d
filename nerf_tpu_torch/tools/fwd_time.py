"""The bf16 forwards on ``csrc/fwd_tile_sm90.cuh``'s tile, timed on the card
at the serving chunk's shapes: K1 (``fwd_bf16_sm90``) on 32,768 rays at
S=64 and S=192 (rays from a radius-4 sphere), K2 at S=63 and S=191 with a
view direction per point, and K5 (``render_bf16_sm90``: K1's tile over ray
groups, then the compositing) at S=64 and S=192 with sigma noise and a
white background, serving (no raw planes kept); W=256 with 10/4 octaves,
seed-0 weights.

    python -m nerf_tpu_torch.tools.fwd_time

prints one JSON line: the card (name, power limit), each level's ms (the
mean of 10 launches after 2, by CUDA events) and each chunk's sum. The
tool imports only ``nerf_tpu_torch``; run as a file with another
checkout's root on ``PYTHONPATH`` it times that checkout's kernels, so two
builds compare in one call (tools/bwd_phase1.py does the same).
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from nerf_tpu_torch.experimental import fused_render
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import fused_mlp

CHUNK = 32 * 1024
LEVELS = {"K1": (64, 192), "K2": (63, 191), "K5": (64, 192)}
WARMUP, REPS = 2, 10


def cuda_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rays(rng: np.random.Generator, S: int, dev):
    ro = rng.standard_normal((CHUNK, 3)).astype(np.float32)
    ro = 4 * ro / np.linalg.norm(ro, axis=-1, keepdims=True)
    rd = (-ro / 4 + 0.3 * rng.standard_normal((CHUNK, 3))).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (CHUNK, S)).astype(np.float32), -1)
    return [torch.from_numpy(a).to(dev) for a in (ro, rd, vd, z)]


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_time: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    mlp = NeRFMLP(MLPConfig(width=256), seed=0, device=dev)
    kp, blobs = fused_mlp.packed_params(mlp, PosEncConfig(10), PosEncConfig(4), torch.bfloat16)
    rng = np.random.default_rng(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    res = {"card": smi}
    for kernel, levels in LEVELS.items():
        for S in levels:
            ro, rd, vd, z = _rays(rng, S, dev)
            if kernel == "K1":
                ms = cuda_ms(lambda: fused_mlp.fused_rays_planes(kp, ro, rd, vd, z, blobs))
            elif kernel == "K5":
                noise = torch.from_numpy(rng.standard_normal((CHUNK, S)).astype(np.float32)).to(dev)
                ms = cuda_ms(lambda: fused_render.fused_render_fwd(kp, ro, rd, vd, z, noise, True,
                                                                   blobs))
            else:
                x = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
                v = vd.repeat_interleave(S, 0)
                ms = cuda_ms(lambda: fused_mlp.fused_points(kp, x, v, 1, blobs))
            res[f"{kernel}_S{S}_ms"] = round(ms, 3)
        res[f"{kernel}_chunk_ms"] = round(sum(res[f"{kernel}_S{S}_ms"] for S in levels), 3)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
