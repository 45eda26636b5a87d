"""The data-parallel train step timed on the cards: n ranks, a card each.

    python -m nerf_tpu_torch.tools.dp_time [n ...]

For each rank count n (default: 1, 2, 4, ... up to the visible cards) the
tool builds the kernels, then spawns n ranks joined by NCCL
(``parallel.distributed.launch``). Each runs ``parallel/mesh.py``'s sharded
step at the lego recipe (configs/lego.txt: 8x256 with viewdirs, 64+128
samples, white background, bf16, its sampler: one image a step, the centre
crop first), N_rand 4096 over all ranks, so 4096 / n rays a rank, on 8
white 400x400 views of the orbit, with seed-0 weights: WARMUP steps, then
WINDOWS windows of STEPS steps between card syncs (ms/step: their median),
then PROFILED steps under torch.profiler (device ms/step, and that of
NCCL's kernels: the all-reduce), then one all-reduce of ones. Prints one
JSON line a rank count, rank 0's numbers, with the card's name and power
limit. The tool imports only ``nerf_tpu_torch``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

LEGO = Path(__file__).resolve().parents[2] / "configs" / "lego.txt"
N_RAND = 4096
H = W = 400
FOCAL = 555.555
VIEWS = 8
WARMUP, WINDOWS, STEPS, PROFILED = 3, 5, 10, 3


def time_rank(device, warmup: int = WARMUP, windows: int = WINDOWS, steps: int = STEPS,
              profiled: int = PROFILED) -> dict:
    """One rank's share: see the module's docstring. Every rank of the
    process group calls it."""
    import torch.distributed as dist

    from nerf_tpu_torch.config import load_config
    from nerf_tpu_torch.data.rays_dataset import make_sampler
    from nerf_tpu_torch.data.scene import Scene, default_intrinsics
    from nerf_tpu_torch.geom.poses import spherical_render_poses
    from nerf_tpu_torch.models.factory import init_nets, make_model
    from nerf_tpu_torch.parallel import distributed
    from nerf_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step, place_state
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.step import init_train_state
    from nerf_tpu_torch.utils.profiler import device_rows

    cfg = load_config([f"--config={LEGO}", f"--N_rand={N_RAND}"])
    mesh = make_mesh(distributed.world_size(), device)
    dev = mesh.device
    poses = np.asarray(spherical_render_poses(40))[:: 40 // VIEWS][:VIEWS, :3, :4]
    scene = Scene(images=np.ones((VIEWS, H, W, 3), np.float32), poses=poses.astype(np.float32),
                  render_poses=poses, hwf=(H, W, FOCAL), K=default_intrinsics(H, W, FOCAL),
                  i_train=np.arange(VIEWS), i_val=np.zeros(0, int), i_test=np.zeros(0, int),
                  near=2.0, far=6.0)
    model = make_model(cfg)
    state = place_state(mesh, init_train_state(init_nets(model, cfg.seed, dev), cfg.lrate))
    step = make_sharded_train_step(mesh, model, render_settings_from_config(cfg), cfg.lrate,
                                   cfg.lrate_decay)
    sampler = make_sampler(scene, cfg, torch.Generator(device=dev).manual_seed(cfg.seed + 1),
                           device=dev, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 2)
    rows = N_RAND // mesh.size
    near = torch.full((rows,), scene.near, device=dev)
    far = torch.full((rows,), scene.far, device=dev)
    done = [0]

    def sync():  # the card's queue (a CPU rank has none)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one():
        done[0] += 1
        ro, rd, target = sampler.next_batch(done[0])
        return step(state, ro, rd, near, far, target, generator=gen)

    for _ in range(warmup):
        one()
    window_ms = []
    for _ in range(windows):
        sync()
        distributed.barrier(mesh.group)
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        sync()
        window_ms.append(1e3 * (time.perf_counter() - t0) / steps)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            aux = one()
        sync()
    device_us = device_rows(prof)
    nccl = [(us, key) for us, key, _ in device_us if "nccl" in key.lower()]
    ones = torch.ones(8, device=dev)
    dist.all_reduce(ones, group=mesh.group)
    return {
        "ranks": mesh.size, "rays_per_rank": rows, "device": str(dev),
        "ms_per_step": float(np.median(window_ms)) if window_ms else None,
        "window_ms_per_step": window_ms,
        "device_ms_per_step": sum(r[0] for r in device_us) / 1e3 / max(profiled, 1),
        "allreduce_ms_per_step": sum(us for us, _ in nccl) / 1e3 / max(profiled, 1),
        "allreduce_kernels": sorted({key[:60] for _, key in nccl}),
        "loss": float(aux["loss"]) if profiled else None,
        "all_reduce_of_ones": ones.tolist(),
    }


def main(argv=None) -> int:
    from nerf_tpu_torch.ops import _build
    from nerf_tpu_torch.parallel import distributed

    if not torch.cuda.is_available():
        print("dp_time: no CUDA device", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    counts = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    counts = counts or [n for n in (1, 2, 4, 8, 16) if n <= cards]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    _build.load_all(["fused_mlp_fwd", "fused_mlp_bwd"])  # once, before the ranks start
    for n in counts:
        out = distributed.launch(time_rank, n, "cuda")[0]
        print(json.dumps({"card": smi, "cards": cards, "n_rand": N_RAND, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
