"""The wide family's six kernels timed on the card at W = 512 with 10 / 4
octaves, bf16, seed-7 weights, at chip_smoke.py phase 26's shapes: K1w, K2w
(a direction per point) and K5w (serving: no raw kept, no noise, a white
background) on a 32,768-ray chunk, K4w, K3w (no input grads) and K6w on an
N_rand 4096 step, each level (64 and 192 samples; K2w / K3w 63 and 191)
the mean of REPS calls after a warm-up, by CUDA events. Then their GEMM
alone (``Ops.gemm``) at a layer of that chunk, M = K = 512 rows and
32,768 x 64 points, with the epilogues the plans use most (the forward's
bias + relu + rows; the chain's mask + rows; bias + relu storing nothing),
beside the same product as one bf16 ``torch.matmul`` (no epilogue).

    python -m nerf_tpu_torch.tools.wide_time

prints one JSON line: the card (name, power limit), each kernel's ms a
level and its sum (ms per chunk or per step), and the GEMM's ms and
TFLOP/s a variant. The tool imports only ``nerf_tpu_torch``; run as a
file with another checkout's root on ``PYTHONPATH`` it times that
checkout's kernels, so two builds compare in one call (tools/fwd_time.py
does the same).
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
from nerf_tpu_torch.ops import fused_mlp, fused_mlp_wide

CHUNK, N_RAND, WIDTH = 32 * 1024, 4096, 512
LEVELS = (64, 192)
REPS = 3


def cuda_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rays(rng: np.random.Generator, R: int, S: int, dev):
    ro = rng.standard_normal((R, 3)).astype(np.float32)
    ro = 4 * ro / np.linalg.norm(ro, axis=-1, keepdims=True)
    rd = (-ro / 4 + 0.3 * rng.standard_normal((R, 3))).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (R, S)).astype(np.float32), -1)
    return [torch.from_numpy(a).to(dev) for a in (ro, rd, vd, z)]


def _points(rays, S: int):
    """(x [R*S, 3], v [R*S, 3]): the rays' points, a direction per point."""
    x = fused_mlp._ray_points(rays[0], rays[1], rays[3])
    return x, rays[2].repeat_interleave(S, 0)


def gemm_times(dev) -> dict:
    """The GEMM alone at M = K = WIDTH, N = CHUNK x 64: ms and TFLOP/s of
    each epilogue variant and of one bf16 torch.matmul."""
    M, N = WIDTH, CHUNK * 64
    ops = fused_mlp_wide.Ops(torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(M, M, device=dev, generator=gen).to(torch.bfloat16)
    b = torch.randn(M, N, device=dev, generator=gen).to(torch.bfloat16)
    bias = torch.randn(M, device=dev, generator=gen)
    mask = torch.randn(M, N, device=dev, generator=gen).to(torch.bfloat16)
    out = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
    res = {}
    for name, fn in (
            ("bias_relu_rows", lambda: ops.gemm(M, N, [(a, M, b)], bias=bias, relu=True, out=out)),
            ("mask_rows", lambda: ops.gemm(M, N, [(a, M, b)], mask=mask, out=out)),
            ("bias_relu_no_rows", lambda: ops.gemm(M, N, [(a, M, b)], bias=bias, relu=True)),
            ("torch_matmul", lambda: torch.matmul(a, b, out=out))):
        ms = cuda_ms(fn, reps=10)
        res[name] = {"ms": round(ms, 4), "tflops": round(2 * M * M * N / ms / 1e9, 1)}
    return res


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        print("wide_time: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    mlp = NeRFMLP(MLPConfig(width=WIDTH), seed=7, device=dev)
    kp, blobs = fused_mlp.packed_params(mlp, PosEncConfig(10), PosEncConfig(4), torch.bfloat16)
    if not fused_mlp.is_wide(kp):
        raise RuntimeError("W = 512 is not a wide configuration")
    rng = np.random.default_rng(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    res = {"card": smi}

    def add(name, S, ms):
        res.setdefault(name, {})[f"S={S}"] = round(ms, 3)
        res[name]["sum"] = round(res[name].get("sum", 0.0) + ms, 3)
        torch.cuda.empty_cache()

    for S in LEVELS:  # a serving chunk
        rays = _rays(rng, CHUNK, S, dev)
        add("K1w", S, cuda_ms(lambda: fused_mlp.fused_rays_planes(kp, *rays, blobs)))
        add("K5w", S, cuda_ms(lambda: fused_render.fused_render_fwd(kp, *rays, None, True, blobs)))
        del rays
        x, v = _points(_rays(rng, CHUNK, S - 1, dev), S - 1)
        add("K2w", S - 1, cuda_ms(lambda: fused_mlp.fused_points(kp, x, v, 1, blobs)))
        del x, v
    for S in LEVELS:  # a training step
        rays = _rays(rng, N_RAND, S, dev)
        g = torch.rand(4, N_RAND, S, device=dev) * 1e-4
        add("K4w", S, cuda_ms(lambda: fused_mlp.fused_rays_planes_bwd(kp, *rays, g, blobs)))
        maps = fused_render.fused_render_fwd(kp, *rays, None, True, blobs, keep_raw=True)
        cot = [torch.rand(m.shape, device=dev) * 1e-3 for m in maps[:4]]
        add("K6w", S, cuda_ms(lambda: fused_render.fused_render_bwd(kp, *rays, None, maps.raw,
                                                                      *cot, True, blobs)))
        del maps, cot, rays, g
        x, v = _points(_rays(rng, N_RAND, S - 1, dev), S - 1)
        gp = torch.rand(x.shape[0], 4, device=dev) * 1e-4
        add("K3w", S - 1, cuda_ms(lambda: fused_mlp.fused_points_bwd(kp, x, v, gp, 1, False,
                                                                        blobs)))
        del x, v, gp
    res["gemm"] = gemm_times(dev)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
