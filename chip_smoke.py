#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``nerf_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
1. device: the card's name and power limit (nvidia-smi);
2. build: compiles csrc/fused_mlp_fwd.cu (K1, K2), csrc/fused_mlp_bwd.cu
   (K4, K3), csrc/fused_render.cu (K5, K6's compositing backward) and
   csrc/probe_overlap.cu (K7) with nvcc (sm_90a), one process each, at once;
3. kernel: K1 against its plain PyTorch version at the full 8x256 width,
   in f32 and bf16;
4. render: renders the first 3 poses of the 40-pose orbit at the lego
   half-res recipe (400x400, 64+128 samples, bf16, white background)
   through ``render_path``; checks shapes, finiteness, 30 K1 launches and
   no other, and 4,096 rays strided over frame 0 against the plain
   (unfused) path;
5. times: K1 at the serving path's shapes (a 32,768-ray chunk, both
   levels), checked against its plain version there and timed beside its
   bound, its plain version and a bf16 ``torch.matmul`` chain;
6. grad: K4 against its plain version at 8x256, f32 and bf16, R=1024 and
   ragged R=1000, S=64 and 192, and (bf16) at the training shapes R=4096;
   two launches must be bit-identical;
7. train: ``train()`` at the lego recipe with N_rand=4096 on 8 views of
   400x400 rendered by a seeded teacher net through ``render_path``: 3
   warm-up and 30 timed steps with exactly 2 K1 and 2 K4 launches each and
   no K2/K3, finite and falling loss, ms/step, rays/s and MFU; then 3 steps
   under ``torch.profiler`` for the device time by kernel and the idle share;
8. grads: one fused step's weight grads against the plain (unfused) path
   on the same batch and draws;
9. bwd times: K4 at the training shapes beside its bound, its plain
   version and the backward's big products as bf16 ``torch.matmul``.
The points-in path (K2 forward, K3 backward), at the 63+128 recipe: 63
coarse samples and 191 fine are not multiples of 8, so both levels query
points (``query_raw`` -> ``fused_query``) with a view direction per point:
10. kernel2 / grad3: K2 and K3 against their plain versions at 8x256, f32
   and bf16, a direction per point (spr=1) and per ray (spr=S), K3 with
   and without input grads (dx, dv) and twice, bit-identical;
11. render: phase 4 at 63+128: 10 K2 launches a frame and no other;
12. train / grads: phases 7 and 8 at 63+128 on the same views: 2 K2 and 2
   K3 launches a step and no K1/K4;
13. k2_times / k3_times: K2 at the chunk's and the step's shapes, K3 at the
   step's, beside their bounds, plain versions and library chains.
The fused-render path (``--fused_render``: K5 from rays to maps with the
compositing in the kernel, K6 its backward), at 64+128 on both levels:
14. kernel5 / grad6: K5 and K6 against their plain versions at 8x256, f32
   and bf16, R=1024 and ragged R=1000, S=64, 192 and 200 (a one-ray
   group), white background on and off, sigma noise on; K6 with one-signed
   cotangents on all four maps, twice, bit-identical;
15. render: phase 4 with ``fused_render``: 10 K5 launches a frame and no
   other kernel;
16. train / grads: phases 7 and 8 with ``fused_render`` on the same views:
   2 K5 and 2 K6 launches a step and none of K1-K4;
17. k5_times / k6_times: K5 per chunk (serving) and K6 per step beside
   their bounds, plain versions and library chains.
The probe path (K7, ``python -m nerf_tpu_torch.tools.probe_overlap``) and
the user's entry path (``cli.train`` / ``cli.render`` on a blender scene):
18. probe: each of K7's nine bodies (the script's eight and ``products``)
   against its plain version at 8x256 on 192 tiles of 128 points (one
   launch each), then the tool's ``main`` at 786,432 points: 1 + 30
   launches a body, its time the median of 5 windows of 6, beside its
   bound and plain version, ``matmul_only`` beside its ``torch.matmul``
   chain;
19. cli train: phase 7's teacher views written as an 800x800 RGBA blender
   scene (6 train, 1 val, 1 test; PNGs through ``write_png``), then
   ``cli.train.main`` with configs/lego.txt (half_res, 64+128, N_rand
   4096) for 24 steps with i_print, i_img, i_weights, i_testset, i_video
   and trace all firing: the [EVAL] lines, a .tar at each i_weights event
   (named 4 steps ahead after the trace's extra steps, as nerf_tpu does),
   the test-set PNG, the 40 spiral frames, a trace.json naming K1's and
   K4's kernels, 2 K1 + 2 K4 launches a step and 10 K1 a frame, nothing
   else, and a finite, falling loss;
20. resume / render: the newest .tar holds the trained state; a second
   ``cli.train.main`` resumes from it (step and learning rate) for 8 more
   steps, and ``cli.render.main --render_test`` renders the test view from
   the .tar it saved, with a finite PSNR and the video.

The last two lines are a JSON object of kernel numbers (K1-K7) and the
``{"ok": true, "device": ...}`` result. Weights are random, from seeds.
The script imports nothing of JAX or of ``nerf_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H = W = 400  # lego half-res
FOCAL = 555.555
NEAR, FAR = 2.0, 6.0
CHUNK = 32 * 1024
N_SAMPLES, N_IMPORTANCE = 64, 128
POINTS_SAMPLES = 63  # the points-in slice: 63 coarse, 191 fine, neither a multiple of 8
N_FRAMES = 3
WIDTH = 256
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
F32_TOL = 1e-4  # summation order + sincosf vs torch.sin ulps only
# bf16 kernel vs its plain version: nerf_tpu's bound (0.25,
# tests/test_fused_mlp.py:186-194) tightened to 5x the largest max abs seen
# on an H100 (4.1e-4, a 32,768-ray chunk at S=192; PERF.md). Both sides round
# the same operands to bf16 and differ only where an f32 sum in another order
# puts an activation on the other side of a bf16 rounding edge. The bound
# must stay below the input-dependent part of raw (``spread``, the mean
# |raw - its channel mean|, printed and checked), or a kernel that lost it
# would pass on the biases alone.
BF16_TOL = 2e-3
# The fused and the plain path sum in other orders (the kernel merges layer
# 0 with the skip, and rgb with alpha), so a few activations round to the
# other bf16 neighbour; one such 1-ulp flip moves rgb_map by up to ~1e-3.
RENDER_RGB_TOL = 1e-3
RENDER_CHECK_RAYS = 4096  # a strided sample over the whole frame
CHECK_RAYS, RAGGED_RAYS = 1024, 1000  # kernel checks: full tiles, and a ragged last tile
N_RAND = 4096  # the training batch (the reference's default)
TRAIN_VIEWS = 8
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 30, 3
K4_F32_TOL = 1e-4  # per-leaf relative L2; sums over points in another order only
# K4 bf16 against its plain version, per-leaf relative L2: both round the
# same operands, and a cotangent whose f32 sum lands on the other side of a
# bf16 rounding edge rounds to the other neighbour. ~7x the largest value
# measured on an H100 (1.345e-4, W05e at R=1024, S=64; PERF.md), far inside
# nerf_tpu's 0.05 (tests/test_fused_mlp.py:175-183).
K4_BF16_TOL = 1e-3
# one fused training step's grads against the plain (unfused) path, per-leaf
# relative L2: the paths round to bf16 at other places (the plain path rounds
# the embedding per input, the kernels merge layer 0 with the skip), and the
# fine depths follow the coarse weights. nerf_tpu's bf16 grad bound.
STEP_GRAD_TOL = 5e-2
# K3's dx and dv against its plain version, per-tensor relative L2. Unlike a
# weight grad, dx and dv are per point: no sum over points averages a
# point's error away. A relu input that the two forwards put on opposite
# sides of zero (f32: within ~1e-7; bf16: at a rounding edge) switches that
# point's whole cotangent chain, and dx multiplies the top octave's d_e by
# 2^9. Measured on an H100 (PERF.md): f32 up to 5.2e-4 (dx, R=1000, S=191),
# bf16 up to 3.3e-3 (dx); bounds ~4x and ~3x that.
K3_INPUT_F32_TOL = 2e-3
K3_INPUT_BF16_TOL = 1e-2
# K7's bodies against their plain versions, relative to the output's largest
# magnitude: two bf16 ulps there (an ulp of a value in [2^k, 2^(k+1)) is
# 2^(k-7)). Both sides round the same operands to bf16 and differ where an
# f32 sum in another order crosses a rounding edge, which moves one output
# by an ulp; measured on an H100 up to 6.1e-3 of the largest magnitude
# (bias_relu, 192 tiles; PERF.md). The bound must stay below the output's
# input-dependent spread (the mean |out - its column mean|), checked.
PROBE_TOL_REL = 2.0 ** -6
PROBE_CHECK_POINTS = 128 * 192  # 192 tiles of 128 points, 128 rays of 192
# the user's entry path: 24 steps with every cadence firing
CLI_STEPS, CLI_RESUMED_STEPS = 24, 8
CLI_CADENCES = {"i_print": 4, "i_img": 8, "i_weights": 12, "i_testset": 24, "i_video": 24}
TRACE_AT, TRACE_STEPS = 12, 4  # nerf_tpu's trace: 4 more steps at start + 12
LEGO_CAMERA_ANGLE_X = 0.6911112070083618  # the lego scene's: focal 1111.11 at 800 pixels
TRACE_KERNELS = ("fwd_bf16", "bwd_tile_bf16", "wgrad_bf16")  # K1's and K4's symbols


def counters():
    """The launch counters of K1-K7, by name."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.ops import fused_mlp
    from nerf_tpu_torch.tools import probe_overlap

    return {"K1": fused_mlp.fused_rays_planes, "K2": fused_mlp.fused_points,
            "K3": fused_mlp.fused_points_bwd, "K4": fused_mlp.fused_rays_planes_bwd,
            "K5": fused_render.fused_render_fwd, "K6": fused_render.fused_render_bwd,
            "K7": probe_overlap.probe}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def check_counts(got, want, what: str) -> None:
    """Exactly ``want`` launches of the named kernels and none of the others."""
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, expected {want}")


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``reps`` calls."""
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


def matmul_chain(kp, n_pts: int):
    """The forward's 10 large matmuls (W05e, W1..W7, Wf, Wvf) as bf16
    torch.matmul calls at the kernel's shapes: a library yardstick, timed
    here only and used nowhere in the port."""
    dev = kp["W1"].device
    e = torch.randn(n_pts, 64, dtype=torch.bfloat16, device=dev)
    h = torch.randn(n_pts, kp["W1"].shape[0], dtype=torch.bfloat16, device=dev)
    w05 = torch.nn.functional.pad(kp["W05e"], (0, 0, 0, 64 - kp["W05e"].shape[0]))
    ws = [kp[f"W{i}"] for i in range(1, 8)] + [kp["Wf"], kp["Wvf"]]

    def run():
        torch.matmul(e, w05)
        for w in ws:
            torch.matmul(h, w)

    return run


def check_kernel(out, ref, tol: float, **fields) -> float:
    """Hold kernel output to its plain version; print the max and mean
    difference beside the plain raw's mean magnitude and its
    input-dependent spread. Returns the max abs difference."""
    d = (out - ref).abs()
    err = float(d.max())
    spread = float((ref - ref.mean(dim=(1, 2), keepdim=True)).abs().mean(dim=(1, 2)).min())
    phase("kernel", **fields, max_abs=f"{err:.3e}", mean_abs=f"{float(d.mean()):.3e}",
          tol=tol, raw_mean_abs=f"{float(ref.abs().mean()):.3e}", spread=f"{spread:.3e}")
    if not bool(torch.isfinite(out).all()) or not err <= tol:
        raise RuntimeError(f"kernel disagrees with its plain version: {err} > {tol}")
    if not tol < spread:
        raise RuntimeError(f"bound {tol} is not below the raw's input-dependent spread {spread}")
    return err


def make_rays(rng: np.random.Generator, R: int, S: int, dev):
    """Rays from a radius-4 sphere towards the origin, depths in [near, far]."""
    ro = rng.standard_normal((R, 3)).astype(np.float32)
    ro = 4.0 * ro / np.linalg.norm(ro, axis=-1, keepdims=True)
    rd = (-ro / 4.0 + 0.3 * rng.standard_normal((R, 3))).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(NEAR, FAR, (R, S)).astype(np.float32), -1)
    return [torch.from_numpy(a).to(dev) for a in (ro, rd, vd, z)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nerf_tpu_torch.data.scene import Scene, default_intrinsics
    from nerf_tpu_torch.geom.poses import spherical_render_poses
    from nerf_tpu_torch.models.embedding import PosEncConfig
    from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
    from nerf_tpu_torch.ops import _build, fused_mlp
    from nerf_tpu_torch.render.network import NeRFModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=repr(smi))

    # 2. build (one nvcc per source, all at once)
    t0 = time.perf_counter()
    sources = ["fused_mlp_fwd", "fused_mlp_bwd", "fused_render", "probe_overlap"]
    _build.load_all(sources)
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}", sources=len(sources))
    for name in sources:
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip(), flush=True)

    # 3. kernel against its plain version at full width
    cfg = MLPConfig(width=WIDTH)
    pe_pts, pe_views = PosEncConfig(10), PosEncConfig(4)
    coarse = NeRFMLP(cfg, seed=0, device=dev)
    fine = NeRFMLP(cfg, seed=1, device=dev)
    rng = np.random.default_rng(0)
    bf16_errs = []
    with torch.no_grad():
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            kp = fused_mlp.pack_params(coarse, pe_pts, pe_views, dtype)
            for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):
                rays = make_rays(rng, CHECK_RAYS, S, dev)
                before = fused_mlp.fused_rays_planes.launches
                out = fused_mlp.fused_rays_planes(kp, *rays)
                torch.cuda.synchronize()
                if fused_mlp.fused_rays_planes.launches != before + 1:
                    raise RuntimeError("the launch counter did not move")
                ref = fused_mlp.fused_rays_planes_reference(kp, *rays)
                err = check_kernel(out, ref, tol, dtype=str(dtype).split(".")[-1], R=CHECK_RAYS,
                                   S=S)
                if dtype == torch.bfloat16:
                    bf16_errs.append(err)

    # 4. render_path over 3 orbit poses
    model = NeRFModel(pe_pts, pe_views, cfg, cfg, compute_dtype="bfloat16", fused=True)
    scene = Scene(images=np.zeros((0, H, W, 3), np.float32), poses=np.zeros((0, 3, 4)),
                  render_poses=spherical_render_poses(40), hwf=(H, W, FOCAL),
                  K=default_intrinsics(H, W, FOCAL), i_train=np.zeros(0, int),
                  i_val=np.zeros(0, int), i_test=np.zeros(0, int), near=NEAR, far=FAR)
    nets = {"coarse": coarse, "fine": fine}
    render = render_phase(nets, model, scene, N_SAMPLES, "K1", dev)

    # 5. times at the main path's shapes (one 32,768-ray chunk, both levels)
    flops_pt = fused_mlp.flops_per_point(cfg, pe_pts, pe_views)
    kp, blobs = fused_mlp.packed_params(coarse, pe_pts, pe_views, torch.bfloat16)
    wbytes = sum(v.numel() * v.element_size() for v in kp.values())
    totals = {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "library_ms": 0.0}
    chunk_rays = [t[:CHUNK] for t in render["rays"]]
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):
            u = torch.rand(CHUNK, S, device=dev, generator=gen)
            z = torch.sort(u * (FAR - NEAR) + NEAR, -1).values
            args = (*chunk_rays, z)
            n_pts = CHUNK * S
            out = fused_mlp.fused_rays_planes(kp, *args, blobs)
            ref = fused_mlp.fused_rays_planes_reference(kp, *args)
            err = check_kernel(out, ref, BF16_TOL, dtype="bfloat16", R=CHUNK, S=S)
            del out, ref
            bf16_errs.append(err)
            ms = cuda_ms(lambda: fused_mlp.fused_rays_planes(kp, *args, blobs), reps=10, warmup=2)
            plain_ms = cuda_ms(lambda: fused_mlp.fused_rays_planes_reference(kp, *args), reps=2)
            torch.cuda.empty_cache()
            chain = matmul_chain(kp, n_pts)
            library_ms = cuda_ms(chain, reps=5)
            del chain
            torch.cuda.empty_cache()
            io_bytes = CHUNK * 9 * 4 + n_pts * 4 + n_pts * 16 + wbytes
            ops_ms = 1e3 * n_pts * flops_pt / PEAK_BF16_FLOPS
            bytes_ms = 1e3 * io_bytes / PEAK_BYTES
            bound_ms = max(ops_ms, bytes_ms)
            phase("times", S=S, points=n_pts, ms=f"{ms:.3f}", bound_ms=f"{bound_ms:.3f}",
                  plain_ms=f"{plain_ms:.3f}", library_ms=f"{library_ms:.3f}",
                  tflops=f"{n_pts * flops_pt / ms / 1e9:.1f}")
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                         ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
                totals[k] += v

    # 6.-9. the training slice
    k4_errs = check_k4(coarse, pe_pts, pe_views, rng, dev)
    train_info = train_phase(scene, dev, N_SAMPLES, "K1", "K4")
    step_grads_phase(train_info, dev)
    k4 = k4_times(cfg, pe_pts, pe_views, dev)

    # 10.-13. the points-in slice at 63+128
    k2_errs, k3_errs = check_k23(coarse, pe_pts, pe_views, rng, dev)
    render63 = render_phase(nets, model, scene, POINTS_SAMPLES, "K2", dev)
    train63 = train_phase(scene, dev, POINTS_SAMPLES, "K2", "K3", views=train_info["views"])
    step_grads_phase(train63, dev)
    k2, k3 = k23_times(cfg, pe_pts, pe_views, render63["rays"], k2_errs, dev)

    # 14.-17. the fused-render path at 64+128
    k5_errs, k6_errs = check_k56(coarse, pe_pts, pe_views, rng, dev)
    model_fr = dataclasses.replace(model, fused_render=True)
    render_fr = render_phase(nets, model_fr, scene, N_SAMPLES, "K5", dev)
    train_fr = train_phase(scene, dev, N_SAMPLES, "K5", "K6", views=train_info["views"],
                           fused_render=True)
    step_grads_phase(train_fr, dev)
    k5, k6 = k56_times(cfg, pe_pts, pe_views, render["rays"], dev)

    # 18.-20. the probe path and the user's entry path
    k7 = probe_phase(dev)
    cli = cli_train_phase(train_info["views"])
    resume_render_phase(cli, dev)

    def row(name, source, replaces, launches, err, t):
        return {
            "name": name, "route": "cuda", "source": f"nerf_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["ops_ms"], t["bytes_ms"]),
            "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
            "library_ms": t["library_ms"],
        }

    kernels = [
        # serving's 30 (3 frames) plus training's 60 (30 steps); bf16 max abs
        # over R=1024 and the chunk shapes; ms per 32,768-ray chunk (S=64 + S=192)
        row("fused_mlp_fwd", "fused_mlp_fwd.cu", "nerf_tpu/ops/fused_mlp.py:464",
            render["counts"]["K1"] + train_info["counts"]["K1"], max(bf16_errs), totals),
        # training's 60; bf16 weight grads; ms per training step (S=64 + S=192)
        row("fused_mlp_bwd", "fused_mlp_bwd.cu", "nerf_tpu/ops/fused_mlp.py:621",
            train_info["counts"]["K4"], max(k4_errs), k4),
        # the 63+128 serving (30) and training (60) launches; bf16 max abs over
        # phase 10's and the chunk shapes; ms per 32,768-ray chunk (S=63 + S=191,
        # a direction per point)
        row("fused_mlp_fwd_points", "fused_mlp_fwd.cu", "nerf_tpu/ops/fused_mlp.py:454",
            render63["counts"]["K2"] + train63["counts"]["K2"], max(k2_errs), k2),
        # the 63+128 training's 60; ms per training step (S=63 + S=191)
        row("fused_mlp_bwd_points", "fused_mlp_bwd.cu", "nerf_tpu/ops/fused_mlp.py:584",
            train63["counts"]["K3"], max(k3_errs), k3),
        # the fused-render serving (30) and training (60) launches; bf16 max
        # abs of the maps over phase 14; ms per 32,768-ray chunk (S=64 + S=192)
        row("fused_render_fwd", "fused_render.cu", "nerf_tpu/experimental/fused_render.py:162",
            render_fr["counts"]["K5"] + train_fr["counts"]["K5"], max(k5_errs), k5),
        # the fused-render training's 60; bf16 weight grads (max abs); ms per
        # training step (S=64 + S=192)
        row("fused_render_bwd", "fused_render.cu", "nerf_tpu/experimental/fused_render.py:182",
            train_fr["counts"]["K6"], max(k6_errs), k6),
        # the probe tool's 9 x (1 + 30) launches; the full body (K1's whole
        # tile) at 786,432 points: its max abs error, ms, plain ms and bound;
        # no one PyTorch call computes it (matmul_only's chain: PERF.md)
        {"name": "probe_overlap", "route": "cuda", "source": "nerf_tpu_torch/csrc/probe_overlap.cu",
         "replaces": "tools/probe_overlap.py:79,181", "launches": k7["launches"],
         "max_abs_err": k7["full"]["max_abs_err"], "ms": k7["full"]["ms"],
         "plain_ms": k7["full"]["plain_ms"], "bound_ms": k7["full"]["bound_ms"],
         "bound_by": k7["full"]["bound_by"], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def render_phase(nets, model, scene, n_samples: int, kernel: str, dev):
    """4 / 11 / 15. render_path over N_FRAMES orbit poses at n_samples + 128:
    shapes, finiteness, exactly 2 launches of ``kernel`` per chunk and none
    of any other, and 4,096 rays strided over frame 0 against the plain
    (unfused) path. Returns the counts, and frame 0's rays for phase 5."""
    from nerf_tpu_torch.geom.rays import get_rays
    from nerf_tpu_torch.render.renderer import RenderSettings, prepare_rays, render_rays
    from nerf_tpu_torch.train.loop import render_path

    rs = RenderSettings(n_samples=n_samples, n_importance=N_IMPORTANCE, perturb=True,
                        use_viewdirs=True, white_bkgd=True)
    poses = scene.render_poses[:N_FRAMES]
    render_path(nets, model, rs, scene, poses[:1], chunk=CHUNK)  # warm-up frame
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rgbs, disps = render_path(nets, model, rs, scene, poses, chunk=CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    n_chunks = -(-H * W // CHUNK)
    if rgbs.shape != (N_FRAMES, H, W, 3) or disps.shape != (N_FRAMES, H, W):
        raise RuntimeError(f"bad output shapes {rgbs.shape} {disps.shape}")
    if not (np.isfinite(rgbs).all() and np.isfinite(disps).all()):
        raise RuntimeError("non-finite frame values")
    check_counts(counts, {kernel: N_FRAMES * 2 * n_chunks}, f"render at S={n_samples}")

    # rays strided over all of frame 0 through the plain (unfused) path
    plain = dataclasses.replace(model, fused=False, fused_render=False)
    c2w = torch.as_tensor(poses[0][:3, :4], dtype=torch.float32, device=dev)
    ro, rd, vd, nv, fv = prepare_rays(*get_rays(H, W, scene.K, c2w), rs, H, W, FOCAL, NEAR, FAR)
    idx = torch.arange(RENDER_CHECK_RAYS, device=dev) * (H * W // RENDER_CHECK_RAYS)
    with torch.no_grad():
        ref = render_rays(nets, plain, rs.eval_mode(), *(t[idx] for t in (ro, rd, vd, nv, fv)))
    fused_rgb = rgbs[0].reshape(-1, 3)[idx.cpu().numpy()]
    render_err = float(np.abs(fused_rgb - ref["rgb_map"].cpu().numpy()).max())
    phase("render", S=n_samples, frames=N_FRAMES, shape=rgbs.shape, launches=counts,
          ms_per_frame=f"{1e3 * seconds / N_FRAMES:.2f}",
          rays_per_s=f"{N_FRAMES * H * W / seconds:.0f}",
          rgb_vs_plain_max_abs=f"{render_err:.3e}", tol=RENDER_RGB_TOL,
          rgb_mean=f"{rgbs.mean():.4f}", rgb_std_checked=f"{fused_rgb.std():.3e}")
    if not render_err <= RENDER_RGB_TOL:
        raise RuntimeError(f"fused render disagrees with the plain path: {render_err}")
    return {"counts": counts, "rays": (ro, rd, vd)}


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def check_k4(mlp, pe_pts, pe_views, rng, dev):
    """6. K4 against its plain version; returns the bf16 max abs errors."""
    from nerf_tpu_torch.ops import fused_mlp

    errs = []
    shapes = [(CHECK_RAYS, N_SAMPLES), (RAGGED_RAYS, N_SAMPLES),
              (CHECK_RAYS, N_SAMPLES + N_IMPORTANCE), (RAGGED_RAYS, N_SAMPLES + N_IMPORTANCE)]
    cases = [(torch.float32, K4_F32_TOL, shapes), (torch.bfloat16, K4_BF16_TOL, shapes + [
        (N_RAND, N_SAMPLES), (N_RAND, N_SAMPLES + N_IMPORTANCE)])]
    gen = torch.Generator(device=dev).manual_seed(1)
    for dtype, tol, dtype_shapes in cases:
        with torch.no_grad():
            kp = fused_mlp.pack_params(mlp, pe_pts, pe_views, dtype)
        for R, S in dtype_shapes:
            rays = make_rays(rng, R, S, dev)
            # the cotangent of an image loss: small and of one sign per channel
            g = (0.5 + torch.rand(4, R, S, device=dev, generator=gen)) * 1e-4
            before = fused_mlp.fused_rays_planes_bwd.launches
            got = fused_mlp.fused_rays_planes_bwd(kp, *rays, g)
            again = fused_mlp.fused_rays_planes_bwd(kp, *rays, g)
            torch.cuda.synchronize()
            if fused_mlp.fused_rays_planes_bwd.launches != before + 2:
                raise RuntimeError("the K4 launch counter did not move")
            ref = fused_mlp.fused_rays_planes_bwd_reference(kp, *rays, g)
            worst, leaf = max((rel_l2(got[n], ref[n]), n) for n in fused_mlp.KP_NAMES)
            max_abs = max(float((got[n] - ref[n]).abs().max()) for n in fused_mlp.KP_NAMES)
            scale = max(float(ref[n].abs().max()) for n in fused_mlp.KP_NAMES)
            same = all(torch.equal(got[n], again[n]) for n in fused_mlp.KP_NAMES)
            finite = all(bool(torch.isfinite(got[n]).all()) for n in fused_mlp.KP_NAMES)
            phase("grad", dtype=str(dtype).split(".")[-1], R=R, S=S,
                  worst_leaf_rel_l2=f"{worst:.3e}", leaf=leaf, tol=tol,
                  max_abs=f"{max_abs:.3e}", grad_max_abs=f"{scale:.3e}",
                  bit_identical=same)
            if not (finite and same and worst <= tol):
                raise RuntimeError(f"K4 disagrees with its plain version or is not "
                                   f"deterministic: {leaf} {worst} > {tol}, same={same}")
            if dtype == torch.bfloat16:
                errs.append(max_abs)
            del got, again, ref
            torch.cuda.empty_cache()
    return errs


def train_phase(scene, dev, n_samples: int, fwd: str, bwd: str, views=None,
                fused_render: bool = False):
    """7 / 12 / 16. train() at the lego recipe with n_samples + 128 samples,
    N_rand=4096, on 8 views rendered by a teacher (rendered here unless
    ``views`` are given): exactly 2 launches of ``fwd`` and of ``bwd`` a
    step and none of any other kernel, a finite and falling loss, the rates,
    and a short profiled window."""
    from nerf_tpu_torch import config
    from nerf_tpu_torch.data.scene import Scene
    from nerf_tpu_torch.models.factory import make_model
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp
    from nerf_tpu_torch.train.loop import render_path, render_settings_from_config, train
    from nerf_tpu_torch.utils.profiler import StepTimer, device_peak_flops

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = config.load_config([
        f"--config={os.path.join(here, 'configs', 'lego.txt')}", f"--N_rand={N_RAND}",
        f"--N_samples={n_samples}",
        f"--n_iters={WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS}", "--i_print=10", "--i_img=0",
        "--i_weights=0", "--i_testset=0", "--i_video=0", "--data_axis=1",
        f"--basedir={os.path.join(here, 'build', 'chip_smoke')}",
        f"--fused_render={fused_render}",
    ])
    model = make_model(cfg)
    rs = render_settings_from_config(cfg)
    if views is None:
        # the targets: 8 views on the orbit rendered by a teacher seeded apart
        teacher = {"coarse": NeRFMLP(model.coarse, seed=1000, device=dev),
                   "fine": NeRFMLP(model.fine, seed=1001, device=dev)}
        poses = scene.render_poses[:: len(scene.render_poses) // TRAIN_VIEWS][:TRAIN_VIEWS]
        images, _ = render_path(teacher, model, rs, scene, poses, chunk=CHUNK, device=dev)
        views = Scene(images=images, poses=np.asarray(poses)[:, :3, :4].astype(np.float32),
                      render_poses=scene.render_poses, hwf=scene.hwf, K=scene.K,
                      i_train=np.arange(TRAIN_VIEWS), i_val=np.zeros(0, int),
                      i_test=np.zeros(0, int), near=NEAR, far=FAR)

    losses, marks = [], {}
    end = WARMUP_STEPS + TIMED_STEPS
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])

    def on_step(i, state, aux):
        if i <= end:
            losses.append(aux["loss"])
        if i in (WARMUP_STEPS, end, end + PROFILED_STEPS):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()
            if i == WARMUP_STEPS:  # the main path's counts start here
                reset_counts()
            elif i == end:  # ... and end here; a short profiled window follows
                marks["counts"] = read_counts()
                prof.__enter__()
            else:
                prof.__exit__(None, None, None)

    result = train(cfg, views, hooks={"on_step": on_step}, device=dev)
    counts = marks["counts"]
    seconds = marks[end] - marks[WARMUP_STEPS]
    loss = torch.stack(losses).cpu().numpy()
    timer = StepTimer(N_RAND, 2 * n_samples + N_IMPORTANCE,
                      fused_mlp.flops_per_point(model.coarse, model.pe_pts, model.pe_views),
                      peak=device_peak_flops(dev))
    rep = timer.report(steps=TIMED_STEPS, elapsed=seconds)
    first, last = float(loss[:5].mean()), float(loss[-5:].mean())
    phase("train", S=n_samples, steps=TIMED_STEPS, n_rand=N_RAND,
          ms_per_step=f"{1e3 * seconds / TIMED_STEPS:.3f}",
          rays_per_s=f"{rep['rays_per_sec']:.0f}",
          mfu="unknown card" if rep["mfu"] is None else f"{rep['mfu']:.4f}",
          launches=counts, loss_first5=f"{first:.6f}", loss_last5=f"{last:.6f}",
          psnr_last=f"{result.history[-1][2]:.3f}" if result.history else "none")
    if not np.isfinite(loss).all():
        raise RuntimeError("non-finite training loss")
    check_counts(counts, {fwd: 2 * TIMED_STEPS, bwd: 2 * TIMED_STEPS},
                 f"{TIMED_STEPS} steps at S={n_samples}")
    if not last < first:
        raise RuntimeError(f"the loss did not fall: {first} -> {last}")
    profile_report(prof, marks[end + PROFILED_STEPS] - marks[end], fwd, bwd)
    return {"cfg": cfg, "model": model, "rs": rs, "views": views, "nets": result.state.nets,
            "counts": counts}


def profile_report(prof, seconds: float, fwd: str, bwd: str) -> None:
    """Device time of the profiled training steps, by kernel and by group
    (the forward kernel ``fwd``, the backward ``bwd``'s kernels, the rest),
    and the device's idle share of the window. The step's launch counts show
    which forward and backward ran: the two pairs share their kernels' names."""
    # the backward's own workspace memset is one of the step's few "Memset"
    # entries; those stay in "other", so its share reads ~0.01 ms low
    k4 = ("bwd_tile_bf16", "ray_prep", "wgrad_bf16", "reduce_splits", "reduce_tiles")
    groups = {fwd: ("render_bf16",) if fwd == "K5" else ("fwd_bf16",),
              bwd: ("composite_bwd",) + k4 if bwd == "K6" else k4}
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, evt.key, evt.count))
    busy_us = sum(r[0] for r in rows)
    share = {g: 0.0 for g in list(groups) + ["other"]}
    for us, key, _ in rows:
        g = next((g for g, keys in groups.items() if any(k in key for k in keys)), "other")
        share[g] += us
    wall_ms = 1e3 * seconds
    phase("profile", steps=PROFILED_STEPS, wall_ms_per_step=f"{wall_ms / PROFILED_STEPS:.3f}",
          device_ms_per_step=f"{busy_us / 1e3 / PROFILED_STEPS:.3f}",
          idle_share=f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f}" if busy_us else "not measured",
          **{f"{g}_ms_per_step": f"{v / 1e3 / PROFILED_STEPS:.3f}" for g, v in share.items()})
    for us, key, count in sorted(rows, reverse=True)[:12]:
        print(f"  device {us / 1e3 / PROFILED_STEPS:8.3f} ms/step  x{count // PROFILED_STEPS:<4d} {key[:90]}",
              flush=True)


def step_grads_phase(info, dev):
    """8 / 12 / 16. one fused step's grads against the plain (unfused) path."""
    from nerf_tpu_torch.geom.rays import get_rays
    from nerf_tpu_torch.train.step import draw_overrides, loss_fn

    model, rs, views, nets = info["model"], info["rs"], info["views"], info["nets"]
    c2w = torch.as_tensor(views.poses[0], device=dev)
    ro, rd = (t.reshape(-1, 3) for t in get_rays(H, W, views.K, c2w))
    idx = torch.arange(CHECK_RAYS, device=dev) * (H * W // CHECK_RAYS)
    ro, rd = ro[idx], rd[idx]
    target = torch.as_tensor(views.images[0], device=dev).reshape(-1, 3)[idx]
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    near = torch.full((CHECK_RAYS,), NEAR, device=dev)
    far = torch.full((CHECK_RAYS,), FAR, device=dev)
    ov = draw_overrides(torch.Generator(device=dev).manual_seed(7), CHECK_RAYS, rs)
    params = [p for level in ("coarse", "fine") for p in nets[level].parameters()]
    names = [f"{level}.{n}" for level in ("coarse", "fine") for n, _ in nets[level].named_parameters()]
    grads = {}
    for fused in (True, False):
        m = model if fused else dataclasses.replace(model, fused=False, fused_render=False)
        loss, _ = loss_fn(nets, m, rs, ro, rd, vd, near, far, target, overrides=ov)
        grads[fused] = torch.autograd.grad(loss, params)
    worst, leaf = max((rel_l2(a, b), n) for n, a, b in zip(names, grads[True], grads[False]))
    phase("grads", S=rs.n_samples, rays=CHECK_RAYS, worst_leaf_rel_l2=f"{worst:.3e}", leaf=leaf, tol=STEP_GRAD_TOL)
    if not worst <= STEP_GRAD_TOL:
        raise RuntimeError(f"fused step grads disagree with the plain path: {leaf} {worst}")


def backward_matmul_chain(kp, n_pts: int):
    """The backward's big products as bf16 torch.matmul calls at K4's
    shapes: the forward recompute (W05e, W1..W7, Wf, Wvf), the cotangents
    d·Wᵀ (Wvf, Wf, W7..W1) and the weight grads aᵀ·d (W05e, W1..W7, Wf,
    Wvf). A library yardstick, timed here only and used nowhere in the port."""
    dev, Wd = kp["W1"].device, kp["W1"].shape[0]
    bf = torch.bfloat16
    e = torch.randn(n_pts, 64, dtype=bf, device=dev)
    a = torch.randn(n_pts, Wd, dtype=bf, device=dev)
    ah = torch.randn(n_pts, Wd // 2, dtype=bf, device=dev)
    d05 = torch.randn(n_pts, 2 * Wd, dtype=bf, device=dev)
    w05 = torch.nn.functional.pad(kp["W05e"], (0, 0, 0, 64 - kp["W05e"].shape[0]))
    trunk = [kp[f"W{i}"] for i in range(1, 8)] + [kp["Wf"]]

    def run():
        torch.matmul(e, w05)
        for w in trunk + [kp["Wvf"]]:
            torch.matmul(a, w)
        torch.matmul(ah, kp["Wvf"].T)
        for w in trunk:
            torch.matmul(a, w.T)
        torch.matmul(e.T, d05)
        for _ in trunk:
            torch.matmul(a.T, a)
        torch.matmul(a.T, ah)

    return run


def k4_times(cfg, pe_pts, pe_views, dev):
    """9. K4 at the training shapes: one coarse and one fine launch a step."""
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp

    mlp = NeRFMLP(cfg, seed=2, device=dev)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, pe_pts, pe_views, torch.bfloat16)
    blobs = fused_mlp.kernel_blobs(kp)
    wbytes = sum(t.numel() * t.element_size() for t in blobs) + 2 * sum(
        kp[n].numel() for n in ("W1", "W2", "W3", "W4", "W5", "W6", "W7", "Wf", "Wvf"))
    gbytes = 4 * sum(v.numel() for v in kp.values())
    rng = np.random.default_rng(5)
    out = {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "library_ms": 0.0}
    for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):
        rays = make_rays(rng, N_RAND, S, dev)
        g = torch.rand(4, N_RAND, S, device=dev) * 1e-4
        n_pts = N_RAND * S
        ms = cuda_ms(lambda: fused_mlp.fused_rays_planes_bwd(kp, *rays, g, blobs), reps=10, warmup=2)
        plain_ms = cuda_ms(lambda: fused_mlp.fused_rays_planes_bwd_reference(kp, *rays, g), reps=2)
        torch.cuda.empty_cache()
        chain = backward_matmul_chain(kp, n_pts)
        library_ms = cuda_ms(chain, reps=5)
        del chain
        torch.cuda.empty_cache()
        flops = fused_mlp.bwd_flops(cfg, pe_pts, pe_views, N_RAND, S)
        io_bytes = N_RAND * 9 * 4 + n_pts * 4 + n_pts * 16 + wbytes + gbytes
        ops_ms = 1e3 * flops / PEAK_BF16_FLOPS
        bytes_ms = 1e3 * io_bytes / PEAK_BYTES
        phase("bwd_times", S=S, points=n_pts, ms=f"{ms:.3f}", bound_ms=f"{max(ops_ms, bytes_ms):.3f}",
              plain_ms=f"{plain_ms:.3f}", library_ms=f"{library_ms:.3f}",
              tflops=f"{flops / ms / 1e9:.1f}")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                     ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
            out[k] += v
    return out



def ray_points(rng, R: int, S: int, spr: int, dev):
    """(x [R*S, 3], v [R*S/spr, 3]): points on make_rays' rays, as the
    renderer makes them (PyTorch's multiply, then add), and their view
    directions per ray (spr = S) or per point (spr = 1)."""
    ro, rd, vd, z = make_rays(rng, R, S, dev)
    x = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(R * S, 3)
    return x, (vd if spr > 1 else vd.repeat_interleave(S, 0))


def check_k23(mlp, pe_pts, pe_views, rng, dev):
    """10. K2 and K3 against their plain versions; returns the bf16 max abs
    errors of K2's raw and of K3's weight grads."""
    from nerf_tpu_torch.ops import fused_mlp

    fine = POINTS_SAMPLES + N_IMPORTANCE
    # (R, S, spr): a direction per point (the renderer's mode here) and per
    # ray (fused_query's at S % 8 == 0), full and ragged tiles
    shapes = [(CHECK_RAYS, POINTS_SAMPLES, 1), (RAGGED_RAYS, POINTS_SAMPLES, 1),
              (RAGGED_RAYS, fine, 1), (CHECK_RAYS, N_SAMPLES, N_SAMPLES),
              (RAGGED_RAYS, N_SAMPLES, N_SAMPLES)]
    cases = [(torch.float32, F32_TOL, K4_F32_TOL, K3_INPUT_F32_TOL, shapes),
             (torch.bfloat16, BF16_TOL, K4_BF16_TOL, K3_INPUT_BF16_TOL,
              shapes + [(N_RAND, POINTS_SAMPLES, 1), (N_RAND, fine, 1)])]
    gen = torch.Generator(device=dev).manual_seed(3)
    k2_errs, k3_errs = [], []
    for dtype, tol, wtol, itol, dtype_shapes in cases:
        dname = str(dtype).split(".")[-1]
        with torch.no_grad():
            kp = fused_mlp.pack_params(mlp, pe_pts, pe_views, dtype)
        for R, S, spr in dtype_shapes:
            x, v = ray_points(rng, R, S, spr, dev)
            before = read_counts()
            out = fused_mlp.fused_points(kp, x, v, spr)
            torch.cuda.synchronize()
            ref = fused_mlp.fused_points_reference(kp, x, v, spr)
            err = check_kernel(out.T.reshape(4, R, S), ref.T.reshape(4, R, S), tol, kernel="K2",
                               dtype=dname, R=R, S=S, spr=spr)
            if dtype == torch.bfloat16:
                k2_errs.append(err)
            del out, ref
            g = (0.5 + torch.rand(R * S, 4, device=dev, generator=gen)) * 1e-4
            weights = {}
            for input_grads in (True, False):
                got = fused_mlp.fused_points_bwd(kp, x, v, g, spr, input_grads)
                again = fused_mlp.fused_points_bwd(kp, x, v, g, spr, input_grads)
                torch.cuda.synchronize()
                ref = fused_mlp.fused_points_bwd_reference(kp, x, v, g, spr, input_grads)
                worst, leaf = max((rel_l2(got[0][n], ref[0][n]), n) for n in fused_mlp.KP_NAMES)
                max_abs = max(float((got[0][n] - ref[0][n]).abs().max())
                              for n in fused_mlp.KP_NAMES)
                same = all(torch.equal(got[0][n], again[0][n]) for n in fused_mlp.KP_NAMES)
                finite = all(bool(torch.isfinite(got[0][n]).all()) for n in fused_mlp.KP_NAMES)
                inputs = {}
                if input_grads:
                    for k, name in ((1, "dx"), (2, "dv")):
                        inputs[name] = rel_l2(got[k], ref[k])
                        same = same and torch.equal(got[k], again[k])
                        finite = finite and bool(torch.isfinite(got[k]).all())
                else:
                    finite = finite and got[1] is None and got[2] is None
                weights[input_grads] = got[0]
                phase("grad3", dtype=dname, R=R, S=S, spr=spr, input_grads=input_grads,
                      worst_leaf_rel_l2=f"{worst:.3e}", leaf=leaf, tol=wtol,
                      max_abs=f"{max_abs:.3e}", bit_identical=same,
                      **{f"{k}_rel_l2": f"{e:.3e}" for k, e in inputs.items()}, input_tol=itol)
                if not (finite and same and worst <= wtol and all(e <= itol for e in inputs.values())):
                    raise RuntimeError(f"K3 disagrees with its plain version or is not "
                                       f"deterministic: {leaf} {worst} {inputs}, same={same}")
                if dtype == torch.bfloat16:
                    k3_errs.append(max_abs)
                del got, again, ref
            # the input-grad branch changes no weight grad
            if not all(torch.equal(weights[True][n], weights[False][n]) for n in fused_mlp.KP_NAMES):
                raise RuntimeError("K3's weight grads depend on input_grads")
            after = read_counts()
            if after["K2"] != before["K2"] + 1 or after["K3"] != before["K3"] + 4:
                raise RuntimeError(f"the K2/K3 launch counters did not move: {before} {after}")
            del weights
            torch.cuda.empty_cache()
    return k2_errs, k3_errs


def k23_times(cfg, pe_pts, pe_views, rays, k2_errs, dev):
    """13. K2 at the serving chunk's shapes (32,768 rays, S=63 and 191, a
    direction per point; checked against its plain version there, the max
    abs errors appended to ``k2_errs``) and at the training step's (4,096
    rays), K3 at the step's without input grads (and once with them), each
    beside its bound, its plain version and the bf16 torch.matmul chain of
    the same products. Returns K2's numbers per chunk and K3's per step."""
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp

    mlp = NeRFMLP(cfg, seed=3, device=dev)
    kp, blobs = fused_mlp.packed_params(mlp, pe_pts, pe_views, torch.bfloat16)
    flops_pt = fused_mlp.flops_per_point(cfg, pe_pts, pe_views)
    wbytes = sum(t.numel() * t.element_size() for t in kp.values())
    chain_bytes = 2 * sum(kp[n].numel() for n in ("W1", "W2", "W3", "W4", "W5", "W6", "W7", "Wf",
                                                   "Wvf", "W05e", "Wve"))
    gbytes = 4 * sum(v.numel() for v in kp.values())
    zero = {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "library_ms": 0.0}
    k2, k2_step, k3 = dict(zero), dict(zero), dict(zero)
    gen = torch.Generator(device=dev).manual_seed(4)
    ro, rd, vd = (t[:CHUNK] for t in rays)
    for S in (POINTS_SAMPLES, POINTS_SAMPLES + N_IMPORTANCE):
        z = torch.sort(torch.rand(CHUNK, S, device=dev, generator=gen) * (FAR - NEAR) + NEAR,
                       -1).values
        for R, total in ((CHUNK, k2), (N_RAND, k2_step)):
            x = (ro[:R, None, :] + rd[:R, None, :] * z[:R, :, None]).reshape(R * S, 3)
            v = vd[:R].repeat_interleave(S, 0)
            n_pts = R * S
            with torch.no_grad():
                if R == CHUNK:
                    out = fused_mlp.fused_points(kp, x, v, 1, blobs)
                    ref = fused_mlp.fused_points_reference(kp, x, v, 1)
                    k2_errs.append(check_kernel(out.T.reshape(4, R, S), ref.T.reshape(4, R, S),
                                                BF16_TOL, kernel="K2", dtype="bfloat16", R=R,
                                                S=S, spr=1))
                    del out, ref
                ms = cuda_ms(lambda: fused_mlp.fused_points(kp, x, v, 1, blobs), reps=10, warmup=2)
                plain_ms = cuda_ms(lambda: fused_mlp.fused_points_reference(kp, x, v, 1), reps=2)
            torch.cuda.empty_cache()
            chain = matmul_chain(kp, n_pts)
            library_ms = cuda_ms(chain, reps=5)
            del chain
            torch.cuda.empty_cache()
            ops_ms = 1e3 * n_pts * flops_pt / PEAK_BF16_FLOPS
            bytes_ms = 1e3 * (n_pts * (12 + 12 + 16) + wbytes) / PEAK_BYTES
            phase("k2_times", R=R, S=S, points=n_pts, ms=f"{ms:.3f}",
                  bound_ms=f"{max(ops_ms, bytes_ms):.3f}", plain_ms=f"{plain_ms:.3f}",
                  library_ms=f"{library_ms:.3f}", tflops=f"{n_pts * flops_pt / ms / 1e9:.1f}")
            for k, t in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                         ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
                total[k] += t
            if R == N_RAND:  # K3 at the step's shape
                g = torch.rand(n_pts, 4, device=dev, generator=gen) * 1e-4
                ms = cuda_ms(lambda: fused_mlp.fused_points_bwd(kp, x, v, g, 1, False, blobs),
                             reps=10, warmup=2)
                ms_in = cuda_ms(lambda: fused_mlp.fused_points_bwd(kp, x, v, g, 1, True, blobs),
                                reps=5, warmup=1)
                plain_ms = cuda_ms(
                    lambda: fused_mlp.fused_points_bwd_reference(kp, x, v, g, 1, False), reps=2)
                torch.cuda.empty_cache()
                chain = backward_matmul_chain(kp, n_pts)
                library_ms = cuda_ms(chain, reps=5)
                del chain
                torch.cuda.empty_cache()
                # a direction per point: dWve sums over points (n_samples=1)
                flops = fused_mlp.bwd_flops(cfg, pe_pts, pe_views, n_pts, 1)
                ops_ms = 1e3 * flops / PEAK_BF16_FLOPS
                bytes_ms = 1e3 * (n_pts * (12 + 12 + 16) + wbytes + chain_bytes + gbytes) / PEAK_BYTES
                phase("k3_times", R=R, S=S, points=n_pts, ms=f"{ms:.3f}",
                      ms_with_input_grads=f"{ms_in:.3f}",
                      bound_ms=f"{max(ops_ms, bytes_ms):.3f}", plain_ms=f"{plain_ms:.3f}",
                      library_ms=f"{library_ms:.3f}", tflops=f"{flops / ms / 1e9:.1f}")
                for k, t in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                             ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
                    k3[k] += t
    phase("k2_step", ms=f"{k2_step['ms']:.3f}", bound_ms=f"{max(k2_step['ops_ms'], k2_step['bytes_ms']):.3f}",
          plain_ms=f"{k2_step['plain_ms']:.3f}", library_ms=f"{k2_step['library_ms']:.3f}")
    return k2, k3


def check_maps(out, ref, tol: float, **fields) -> float:
    """Hold K5's maps to its plain version's: rgb, disp (where finite in
    both, the same rays), acc and w; the bound must stay below the rgb
    map's input-dependent spread. Returns the max abs difference."""
    errs = {}
    for name, a, b in zip(("rgb", "disp", "acc", "w"), out, ref):
        f = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), f):
            raise RuntimeError(f"K5's {name} is finite where its plain version's is not")
        errs[name] = float((a[f] - b[f]).abs().max())
    err = max(errs.values())
    spread = float((ref.rgb - ref.rgb.mean(0)).abs().mean(0).min())
    phase("kernel5", **fields, **{f"{k}_max_abs": f"{v:.3e}" for k, v in errs.items()}, tol=tol,
          rgb_spread=f"{spread:.3e}")
    if not err <= tol:
        raise RuntimeError(f"K5 disagrees with its plain version: {errs} > {tol}")
    if not tol < spread:
        raise RuntimeError(f"bound {tol} is not below the rgb map's spread {spread}")
    return err


@torch.no_grad()
def check_k56(mlp, pe_pts, pe_views, rng, dev):
    """14. K5 and K6 against their plain versions; returns the bf16 max abs
    errors of K5's maps and of K6's weight grads."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.ops import fused_mlp

    shapes = [(R, S) for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE, 200)
              for R in (CHECK_RAYS, RAGGED_RAYS)]
    gen = torch.Generator(device=dev).manual_seed(5)
    k5_errs, k6_errs = [], []
    for dtype, tol, wtol in ((torch.float32, F32_TOL, K4_F32_TOL),
                             (torch.bfloat16, BF16_TOL, K4_BF16_TOL)):
        dname = str(dtype).split(".")[-1]
        kp = fused_mlp.pack_params(mlp, pe_pts, pe_views, dtype)
        for R, S in shapes:
            rays = make_rays(rng, R, S, dev)
            noise = torch.randn(R, S, device=dev, generator=gen) * 0.5
            for white in (True, False):
                before = read_counts()
                out = fused_render.fused_render_fwd(kp, *rays, noise, white, keep_raw=True)
                torch.cuda.synchronize()
                ref = fused_render.fused_render_reference(kp, *rays, noise, white)
                err = check_maps(out, ref, tol, dtype=dname, R=R, S=S, white=white)
                same_raw = torch.equal(out.raw, fused_mlp.fused_rays_planes(kp, *rays))
                # the cotangents of an image loss and its companions: one-signed
                g = [(0.5 + torch.rand(*shape, device=dev, generator=gen)) * 1e-4
                     for shape in ((R, 3), (R,), (R,), (R, S))]
                got = fused_render.fused_render_bwd(kp, *rays, noise, out.raw, *g, white)
                again = fused_render.fused_render_bwd(kp, *rays, noise, out.raw, *g, white)
                torch.cuda.synchronize()
                gref = fused_render.fused_render_bwd_reference(kp, *rays, noise, out.raw, *g,
                                                               white)
                worst, leaf = max((rel_l2(got[n], gref[n]), n) for n in fused_mlp.KP_NAMES)
                max_abs = max(float((got[n] - gref[n]).abs().max()) for n in fused_mlp.KP_NAMES)
                same = all(torch.equal(got[n], again[n]) for n in fused_mlp.KP_NAMES)
                finite = all(bool(torch.isfinite(got[n]).all()) for n in fused_mlp.KP_NAMES)
                phase("grad6", dtype=dname, R=R, S=S, white=white,
                      worst_leaf_rel_l2=f"{worst:.3e}", leaf=leaf, tol=wtol,
                      max_abs=f"{max_abs:.3e}", bit_identical=same, raw_is_k1=same_raw)
                if not (finite and same and same_raw and worst <= wtol):
                    raise RuntimeError(f"K6 disagrees with its plain version or is not "
                                       f"deterministic, or K5's raw is not K1's: {leaf} "
                                       f"{worst}, same={same}, raw={same_raw}")
                after = read_counts()
                moved = {k: after[k] - before[k] for k in after}
                if moved != {"K1": 1, "K2": 0, "K3": 0, "K4": 0, "K5": 1, "K6": 2, "K7": 0}:
                    raise RuntimeError(f"the K5/K6 launch counters moved wrongly: {moved}")
                if dtype == torch.bfloat16:
                    k5_errs.append(err)
                    k6_errs.append(max_abs)
                del out, ref, got, again, gref
            torch.cuda.empty_cache()
    return k5_errs, k6_errs


def k56_times(cfg, pe_pts, pe_views, rays, dev):
    """17. K5 at the serving chunk's shapes (32,768 rays of frame 0, S=64 and
    192, no noise, no raw kept) and K6 at the training step's (4,096 rays,
    with noise, from K5's raw), each beside its bound, its plain version and
    the bf16 torch.matmul chain of the same products. Returns K5's numbers
    per chunk and K6's per step."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp

    mlp = NeRFMLP(cfg, seed=6, device=dev)
    kp, blobs = fused_mlp.packed_params(mlp, pe_pts, pe_views, torch.bfloat16)
    flops_pt = fused_mlp.flops_per_point(cfg, pe_pts, pe_views)
    wbytes = sum(t.numel() * t.element_size() for t in kp.values())
    chain_bytes = 2 * sum(kp[n].numel() for n in ("W1", "W2", "W3", "W4", "W5", "W6", "W7", "Wf",
                                                   "Wvf"))
    gbytes = 4 * sum(v.numel() for v in kp.values())
    zero = {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "library_ms": 0.0}
    k5, k6 = dict(zero), dict(zero)
    gen = torch.Generator(device=dev).manual_seed(6)
    ro, rd, vd = (t[:CHUNK] for t in rays)
    for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):
        z = torch.sort(torch.rand(CHUNK, S, device=dev, generator=gen) * (FAR - NEAR) + NEAR,
                       -1).values
        args = (ro, rd, vd, z, None, True)
        n_pts = CHUNK * S
        with torch.no_grad():
            ms = cuda_ms(lambda: fused_render.fused_render_fwd(kp, *args, blobs), reps=10, warmup=2)
            plain_ms = cuda_ms(lambda: fused_render.fused_render_reference(kp, *args), reps=2)
        torch.cuda.empty_cache()
        chain = matmul_chain(kp, n_pts)
        library_ms = cuda_ms(chain, reps=5)
        del chain
        torch.cuda.empty_cache()
        # rays and z in; rgb, disp, acc and w out
        io_bytes = CHUNK * 9 * 4 + n_pts * 4 + CHUNK * 5 * 4 + n_pts * 4 + wbytes
        ops_ms = 1e3 * n_pts * flops_pt / PEAK_BF16_FLOPS
        bytes_ms = 1e3 * io_bytes / PEAK_BYTES
        phase("k5_times", R=CHUNK, S=S, points=n_pts, ms=f"{ms:.3f}",
              bound_ms=f"{max(ops_ms, bytes_ms):.3f}", plain_ms=f"{plain_ms:.3f}",
              library_ms=f"{library_ms:.3f}", tflops=f"{n_pts * flops_pt / ms / 1e9:.1f}")
        for k, t in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                     ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
            k5[k] += t
        # K6 at the step's shape: 4,096 rays with noise, from K5's raw
        R = N_RAND
        step = (ro[:R], rd[:R], vd[:R], z[:R])
        noise = torch.randn(R, S, device=dev, generator=gen)
        raw = fused_render.fused_render_fwd(kp, *step, noise, True, blobs, keep_raw=True).raw
        g = [torch.rand(*shape, device=dev, generator=gen) * 1e-4
             for shape in ((R, 3), (R,), (R,), (R, S))]
        n_pts = R * S
        ms = cuda_ms(lambda: fused_render.fused_render_bwd(kp, *step, noise, raw, *g, True, blobs),
                     reps=10, warmup=2)
        plain_ms = cuda_ms(
            lambda: fused_render.fused_render_bwd_reference(kp, *step, noise, raw, *g, True), reps=2)
        torch.cuda.empty_cache()
        chain = backward_matmul_chain(kp, n_pts)
        library_ms = cuda_ms(chain, reps=5)
        del chain
        torch.cuda.empty_cache()
        flops = fused_mlp.bwd_flops(cfg, pe_pts, pe_views, R, S)
        # rays, z, noise, raw and g_w in per point, g_rgb/disp/acc per ray, the
        # weights (and their [in, out] copy) in, the grads out
        io_bytes = (R * 9 * 4 + n_pts * (4 + 4 + 16 + 4) + R * 5 * 4 + wbytes + chain_bytes
                    + gbytes)
        ops_ms = 1e3 * flops / PEAK_BF16_FLOPS
        bytes_ms = 1e3 * io_bytes / PEAK_BYTES
        phase("k6_times", R=R, S=S, points=n_pts, ms=f"{ms:.3f}",
              bound_ms=f"{max(ops_ms, bytes_ms):.3f}", plain_ms=f"{plain_ms:.3f}",
              library_ms=f"{library_ms:.3f}", tflops=f"{flops / ms / 1e9:.1f}")
        for k, t in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                     ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
            k6[k] += t
        del raw, g
        torch.cuda.empty_cache()
    return k5, k6


def probe_phase(dev):
    """18. K7's bodies against their plain versions (one launch each), then
    the probe tool at the script's size. Returns the tool's rows by body and
    its launch count."""
    from nerf_tpu_torch.tools import probe_overlap as P

    inp = P.make_inputs(npts=PROBE_CHECK_POINTS, seed=1).to(dev)
    for body in P.BODIES:
        before = P.probe.launches
        out = P.probe(body, inp)
        torch.cuda.synchronize()
        if P.probe.launches != before + 1:
            raise RuntimeError("the K7 launch counter did not move by one")
        ref = P.probe_reference(body, inp)
        live = ref[:, :4] if body == "full" else ref  # full's channels 4.. are zeros
        tol = PROBE_TOL_REL * float(live.abs().max())
        err = float((out - ref).abs().max())
        spread = float((live - live.mean(0)).abs().mean())
        phase("probe", body=body, points=PROBE_CHECK_POINTS, max_abs=f"{err:.3e}",
              tol=f"{tol:.3e}", rel=f"{err / float(live.abs().max()):.3e}", spread=f"{spread:.3e}")
        if not bool(torch.isfinite(out).all()) or not err <= tol:
            raise RuntimeError(f"K7 {body} disagrees with its plain version: {err} > {tol}")
        if not tol < spread:
            raise RuntimeError(f"K7 {body}: bound {tol} is not below the spread {spread}")
        del out, ref
    torch.cuda.empty_cache()
    reset_counts()
    rows = P.main(device=dev)
    counts = read_counts()
    check_counts(counts, {"K7": len(P.BODIES) * (1 + P.REPS)}, "the probe tool")
    by_body = {r["body"]: r for r in rows}
    for r in rows:
        tol = PROBE_TOL_REL * r["plain_max_abs"]
        if not r["max_abs_err"] <= tol:
            raise RuntimeError(f"K7 {r['body']} at {P.NPTS} points: {r['max_abs_err']} > {tol}")
    bare = by_body["matmul_only"]["ms"]
    phase("probe_times", points=P.NPTS, launches=counts["K7"],
          **{f"{b}_ms": f"{r['ms']:.3f}" for b, r in by_body.items()},
          **{f"{b}_vs_matmul_only": f"{r['ms'] / bare:.4f}" for b, r in by_body.items()},
          matmul_chain_ms=f"{by_body['matmul_only']['library_ms']:.3f}")
    torch.cuda.empty_cache()
    return {"launches": counts["K7"], **by_body}


class Tee:
    """Copies what is written to it into the real stdout and a buffer."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def run_cli(fn, argv):
    """fn(argv) on the card (no device argument: the entry point's default),
    its stdout shown and returned."""
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = fn(argv)
    torch.cuda.synchronize()
    return result, tee.text()


def write_blender_scene(views, datadir: str) -> None:
    """Phase 7's 400x400 teacher views as an 800x800 RGBA blender scene:
    each pixel repeated 2x2 (so half_res's 2x2 mean gives the 8-bit view
    back), alpha 1, views 0-5 train, 6 val, 7 test, the lego camera angle."""
    from nerf_tpu_torch.utils.io import write_png
    from nerf_tpu_torch.utils.metrics import to8b

    splits = {"train": range(0, 6), "val": range(6, 7), "test": range(7, 8)}
    for split, ids in splits.items():
        os.makedirs(os.path.join(datadir, split), exist_ok=True)
        frames = []
        for k, v in enumerate(ids):
            rgb = to8b(views.images[v]).repeat(2, 0).repeat(2, 1)
            rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)
            write_png(os.path.join(datadir, split, f"r_{k}.png"), rgba)
            pose = np.concatenate([views.poses[v], [[0.0, 0.0, 0.0, 1.0]]], 0)
            frames.append({"file_path": f"./{split}/r_{k}", "transform_matrix": pose.tolist()})
        with open(os.path.join(datadir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": LEGO_CAMERA_ANGLE_X, "frames": frames}, f)


def cli_argv(root: str, n_iters: int, trace: bool):
    here = os.path.dirname(os.path.abspath(__file__))
    return [f"--config={os.path.join(here, 'configs', 'lego.txt')}",
            f"--datadir={os.path.join(root, 'lego')}", f"--basedir={os.path.join(root, 'logs')}",
            "--expname=cli", f"--N_rand={N_RAND}", f"--n_iters={n_iters}", "--data_axis=1",
            f"--trace={trace}"] + [f"--{k}={v}" for k, v in CLI_CADENCES.items()]


def cli_train_phase(views):
    """19. ``cli.train.main`` on a blender scene written from phase 7's
    teacher views, every cadence and the trace firing."""
    from nerf_tpu_torch.cli import train as cli_train
    from nerf_tpu_torch.data.blender import load_blender_scene
    from nerf_tpu_torch.utils.io import read_png

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    t0 = time.perf_counter()
    write_blender_scene(views, os.path.join(root, "lego"))
    scene = load_blender_scene(os.path.join(root, "lego"), half_res=True, testskip=8,
                               white_bkgd=True)
    scene_err = float(np.abs(scene.images - views.images).max())
    if scene.images.shape != (8, H, W, 3) or not scene_err <= 1.0 / 255:
        raise RuntimeError(f"the written scene does not load back: {scene.images.shape}, {scene_err}")
    if abs(scene.focal - FOCAL) > 1e-2:
        raise RuntimeError(f"focal {scene.focal}, the teacher's {FOCAL}")
    write_s = time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    result, out = run_cli(cli_train.main, cli_argv(root, CLI_STEPS, trace=True))
    seconds = time.perf_counter() - t0
    counts = read_counts()
    expdir = os.path.join(root, "logs", "cli")
    steps = CLI_STEPS + TRACE_STEPS
    c = CLI_CADENCES
    frames = (CLI_STEPS // c["i_img"]) + (CLI_STEPS // c["i_testset"]) * 1 + (
        CLI_STEPS // c["i_video"]) * 40
    n_chunks = -(-H * W // CHUNK)
    check_counts(counts, {"K1": 2 * steps + 2 * n_chunks * frames, "K4": 2 * steps},
                 f"cli.train: {steps} steps and {frames} eval frames")
    evals = [float(m) for m in re.findall(r"\[EVAL\] Iter: \d+ holdout view 6 PSNR: (\S+)", out)]
    if len(evals) != CLI_STEPS // c["i_img"] or not np.isfinite(evals).all():
        raise RuntimeError(f"expected {CLI_STEPS // c['i_img']} holdout evals, got {evals}")
    # a .tar at each i_weights event, named by state.step: 4 ahead after the trace
    want_tars = [f"{i + (TRACE_STEPS if i >= TRACE_AT else 0):06d}.tar"
                 for i in range(c["i_weights"], CLI_STEPS + 1, c["i_weights"])]
    tars = sorted(f for f in os.listdir(expdir) if f.endswith(".tar"))
    if tars != want_tars or result.state.step != steps:
        raise RuntimeError(f"checkpoints {tars} (want {want_tars}), step {result.state.step}")
    test_png = read_png(os.path.join(expdir, f"testset_{CLI_STEPS:06d}", "000.png"))
    spiral = [f for f in os.listdir(expdir) if f.startswith(f"cli_spiral_{CLI_STEPS:06d}_rgb")]
    n_spiral = (40 if spiral and spiral[0].endswith(".mp4") else
                len(os.listdir(os.path.join(expdir, spiral[0]))) if spiral else 0)
    if test_png.shape != (H, W, 3) or n_spiral != 40:
        raise RuntimeError(f"test PNG {test_png.shape}, spiral {spiral} with {n_spiral} frames")
    with open(os.path.join(expdir, "trace", "trace.json")) as f:
        trace_text = f.read()
    trace_kernels = {k: trace_text.count(k) for k in TRACE_KERNELS}
    if not all(trace_kernels.values()):
        raise RuntimeError(f"trace.json names no K1/K4 kernel: {trace_kernels}")
    losses = [h[1] for h in result.history]
    phase("cli_train", steps=steps, seconds=f"{seconds:.2f}", scene_write_load_s=f"{write_s:.2f}",
          scene_vs_views_max_abs=f"{scene_err:.2e}", launches=counts, eval_frames=frames,
          holdout_psnr=[f"{p:.3f}" for p in evals], tars=tars,
          spiral=f"{spiral[0]} ({n_spiral} frames)", trace_bytes=len(trace_text),
          trace_kernel_events=trace_kernels, loss_first=f"{losses[0]:.6f}",
          loss_last=f"{losses[-1]:.6f}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise RuntimeError(f"the loss is not finite and falling: {losses}")
    return {"root": root, "expdir": expdir, "state": result.state}


def resume_render_phase(cli, dev):
    """20. The newest .tar holds phase 19's final state; ``cli.train.main``
    resumes from it (step and learning rate); ``cli.render.main
    --render_test`` renders the test view from the .tar that run saved."""
    from nerf_tpu_torch.cli import render as cli_render
    from nerf_tpu_torch.cli import train as cli_train
    from nerf_tpu_torch.config import load_config
    from nerf_tpu_torch.models.factory import make_model
    from nerf_tpu_torch.train.loop import TrainResult
    from nerf_tpu_torch.train.step import lr_schedule
    from nerf_tpu_torch.utils import checkpoint
    from nerf_tpu_torch.utils.io import read_png

    root, expdir, trained = cli["root"], cli["expdir"], cli["state"]
    start = trained.step
    argv = cli_argv(root, start + CLI_RESUMED_STEPS, trace=False)
    cfg = load_config(argv)
    newest = checkpoint.find_checkpoints(cfg.basedir, cfg.expname)[-1]
    saved = checkpoint.load_checkpoint(newest, make_model(cfg), cfg.lrate, device=dev)
    same = saved.step == start and all(
        torch.equal(a, b) for lvl in ("coarse", "fine")
        for a, b in zip(saved.nets[lvl].parameters(), trained.nets[lvl].parameters()))
    same = same and all(
        torch.equal(saved.optimizer.state[a][k], trained.optimizer.state[b][k])
        for lvl in ("coarse", "fine")
        for a, b in zip(saved.nets[lvl].parameters(), trained.nets[lvl].parameters())
        for k in ("exp_avg", "exp_avg_sq"))
    if not same:
        raise RuntimeError(f"{newest} does not hold the trained state")
    reset_counts()
    result, _ = run_cli(cli_train.main, argv)
    resumed_counts = read_counts()
    # the schedule carried on from the step: the last update used lr(step - 1)
    last_lr = result.state.optimizer.param_groups[0]["lr"]
    want_lr = lr_schedule(cfg.lrate, cfg.lrate_decay)(start + CLI_RESUMED_STEPS - 1)
    first_print = result.history[0][0] if result.history else None
    every = CLI_CADENCES["i_print"]
    if result.state.step != start + CLI_RESUMED_STEPS or last_lr != want_lr or \
            first_print != (start // every + 1) * every:
        raise RuntimeError(f"the resumed run did not carry on from {newest}: step "
                           f"{result.state.step}, lr {last_lr} (want {want_lr}), first "
                           f"print at {first_print}")
    n_chunks = -(-H * W // CHUNK)
    evals = sum(1 for i in range(start + 1, start + CLI_RESUMED_STEPS + 1)
                if i % CLI_CADENCES["i_img"] == 0)
    check_counts(resumed_counts, {"K1": 2 * CLI_RESUMED_STEPS + 2 * n_chunks * evals,
                                  "K4": 2 * CLI_RESUMED_STEPS}, "the resumed run")

    reset_counts()
    rendered, out = run_cli(cli_render.main, argv + ["--render_test"])
    render_counts = read_counts()
    check_counts(render_counts, {"K1": 2 * n_chunks}, "cli.render --render_test")
    psnr = [float(m) for m in re.findall(r"\[EVAL\] mean PSNR over 1 views: (\S+)", out)]
    savedir = os.path.join(expdir, f"renderonly_test_{rendered.state.step:06d}")
    png = read_png(os.path.join(savedir, "000.png"))
    video = sorted(f for f in os.listdir(savedir) if f.startswith("video"))
    phase("resume_render", newest=os.path.basename(newest), resumed_from=start,
          first_print=first_print, last_lr=f"{last_lr:.6e}", resumed_launches=resumed_counts,
          render_step=rendered.state.step, render_launches=render_counts,
          test_psnr=psnr, png=png.shape, video=video)
    if not (isinstance(rendered, TrainResult) and rendered.state.step == start + CLI_RESUMED_STEPS
            and len(psnr) == 1 and np.isfinite(psnr[0]) and png.shape == (H, W, 3) and video):
        raise RuntimeError("cli.render did not render the test view from the newest .tar")
    shutil.rmtree(root)


if __name__ == "__main__":
    sys.exit(main())
