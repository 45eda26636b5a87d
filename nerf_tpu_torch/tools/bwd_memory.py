"""Peak device memory of two training steps at the shapes where the MLP
backward's workspace is largest (ROADMAP C.8), on the card.

    python -m nerf_tpu_torch.tools.bwd_memory [name ...]

Each configuration is the lego recipe's nets (8 layers, viewdirs, 10 / 4
octaves, 64 + 128 samples, white background, bf16) at a width and batch
that make the backward's workspace large:

- ``w512_nrand16384``: W = 512 (NeRF in the Wild's width), N_rand 16384;
- ``stacked16_w512``: 16 scenes of 1024 rays at W = 512, one stacked step
  (``parallel/multi_scene.py::make_multi_scene_step``);
- ``stacked8_w1024``: 8 scenes of 1024 rays at W = 1024;
- ``mipnerf360``: mip-NeRF 360's NeRF baseline shape, W = 1024 and batches
  of 2^14 rays (Barron et al., CVPR 2022).

Each trains two steps from seeded weights on random rays (origins on a
sphere of radius 4 looking past its centre, targets uniform) through the
port's own step, and prints one JSON line: the card (nvidia-smi's name and
power limit), ``peak_gib`` (``torch.cuda.max_memory_allocated`` over the two
steps), ``ms_second_step`` (the second step, synchronized), the backward's
calls a step (K4w or K4ws: more than 2 where the backward was sliced), the
loss, or ``error`` where a step failed (an out-of-memory error is recorded,
not raised: it is the finding). The tool imports only ``nerf_tpu_torch``; run
as a file with another checkout's root on ``PYTHONPATH`` it measures that
checkout.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import torch

from nerf_tpu_torch.config import load_config
from nerf_tpu_torch.models.factory import init_nets, make_model
from nerf_tpu_torch.ops import fused_mlp_wide
from nerf_tpu_torch.parallel.multi_scene import (init_multi_scene_state, make_multi_scene_step,
                                                 scene_seed)
from nerf_tpu_torch.train.loop import render_settings_from_config
from nerf_tpu_torch.train.step import init_train_state, make_train_step

CONFIGS = {
    "w512_nrand16384": dict(width=512, n_rand=16384, scenes=0),
    "stacked16_w512": dict(width=512, n_rand=1024, scenes=16),
    "stacked8_w1024": dict(width=1024, n_rand=1024, scenes=8),
    "mipnerf360": dict(width=1024, n_rand=16384, scenes=0),
}
STEPS = 2


def _rays(gen: torch.Generator, shape, dev):
    def u(*s):
        return torch.rand(*shape, *s, generator=gen, device=dev)

    ro = u(3) * 2 - 1
    ro = 4 * ro / ro.norm(dim=-1, keepdim=True)
    rd = -ro / 4 + 0.3 * (u(3) * 2 - 1)
    near, far = torch.full(shape, 2.0, device=dev), torch.full(shape, 6.0, device=dev)
    return ro, rd, near, far, u(3)


def _backward_calls() -> int:
    return (fused_mlp_wide.fused_rays_planes_wide_bwd.launches
            + fused_mlp_wide.fused_rays_planes_wide_stacked_bwd.launches)


def measure(name: str, width: int, n_rand: int, scenes: int, dev) -> dict:
    cfg = load_config(["--dataset_type=blender", f"--netwidth={width}",
                       f"--netwidth_fine={width}", "--use_viewdirs", "--white_bkgd",
                       "--N_samples=64", "--N_importance=128", f"--N_rand={n_rand}"])
    model = make_model(cfg)
    rs = render_settings_from_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    if scenes:
        state = init_multi_scene_state(model, [scene_seed(0, k) for k in range(scenes)],
                                       cfg.lrate, device=dev)
        step = make_multi_scene_step(model, rs, cfg.lrate, cfg.lrate_decay, scenes)
        gens = [torch.Generator(device=dev).manual_seed(k + 1) for k in range(scenes)]
        shape, kw = (scenes, n_rand), {"generators": gens}
    else:
        state = init_train_state(init_nets(model, 0, dev), cfg.lrate)
        step = make_train_step(model, rs, cfg.lrate, cfg.lrate_decay)
        shape, kw = (n_rand,), {"generator": torch.Generator(device=dev).manual_seed(1)}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    calls0 = _backward_calls()
    ms = None
    for i in range(STEPS):
        t0 = time.perf_counter()
        aux = step(state, *_rays(gen, shape, dev), **kw)
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
    return {"config": name, "width": width, "n_rand": n_rand, "scenes": scenes,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "ms_second_step": ms, "backward_calls_per_step": (_backward_calls() - calls0) / STEPS,
            "loss": float(aux["loss"].sum())}


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(CONFIGS)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    for name in names:
        try:
            row = measure(name, **CONFIGS[name], dev=dev)
        except torch.cuda.OutOfMemoryError as e:
            row = {"config": name, **CONFIGS[name], "error": "out of memory",
                   "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                   "message": str(e).splitlines()[0][:300]}
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"card": card, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
