"""Wall ms/step of ``train()``'s loop on the card, fused and step by step.

    python -m nerf_tpu_torch.tools.loop_time

The lego recipe (configs/lego.txt: 8x256 with viewdirs, 64+128 samples,
white background, bf16, its sampler: one image a step, the centre crop
first) on 8 white 400x400 views of the orbit from seed-0 weights, at
N_rand 4096 and 1024. For each, ``train()`` with ``fuse_steps`` FUSE
(chunks of FUSE steps, i_print the same) and with 1: the wall time of a run
of LONG steps less that of a run of SHORT, over the steps between. Each run
ends in its last print's fetch, a sync of the card, so set-up and the first
chunk's capture cancel; a capture's gc and cache release vary by ~0.2 s a
run, hence the 200 steps between. After a run that only warms up, each
length runs twice, alternating; the medians. Prints one JSON line: the
card (nvidia-smi's name and power limit) and ms/step by N_rand and loop.

The tool imports only ``nerf_tpu_torch``; run as a file with another
checkout's root on ``PYTHONPATH`` it times that checkout (one that predates
the fused loop ignores ``fuse_steps``: both of its loops step by step), so
two checkouts compare in one call. chip_smoke.py phase 31 calls
``measure`` on its teacher views.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

LEGO = Path(__file__).resolve().parents[2] / "configs" / "lego.txt"
N_RANDS = (4096, 1024)
FUSE = 10
SHORT, LONG = 10, 210
H = W = 400
FOCAL = 555.555
VIEWS = 8


def white_views():
    """8 white 400x400 views on the lego orbit (the recipe's sampler)."""
    from nerf_tpu_torch.data.scene import Scene, default_intrinsics
    from nerf_tpu_torch.geom.poses import spherical_render_poses

    poses = np.asarray(spherical_render_poses(40))[:: 40 // VIEWS][:VIEWS, :3, :4]
    return Scene(images=np.ones((VIEWS, H, W, 3), np.float32), poses=poses.astype(np.float32),
                 render_poses=poses, hwf=(H, W, FOCAL), K=default_intrinsics(H, W, FOCAL),
                 i_train=np.arange(VIEWS), i_val=np.zeros(0, int), i_test=np.zeros(0, int),
                 near=2.0, far=6.0)


def measure(scene, dev, n_rands=N_RANDS, fuse: int = FUSE) -> dict:
    """{n_rand: {"fused": ms/step, "per_step": ms/step}} of ``train()`` on
    ``scene`` with the lego recipe (see the module's docstring)."""
    from nerf_tpu_torch.config import load_config
    from nerf_tpu_torch.train.loop import train

    basedir = tempfile.mkdtemp(prefix="loop_time_")
    out = {}
    for n_rand in n_rands:
        out[n_rand] = {}
        for name, k in (("fused", fuse), ("per_step", 1)):
            walls = {SHORT: [], LONG: []}
            for n in (SHORT, SHORT, LONG, SHORT, LONG):
                cfg = load_config([
                    f"--config={LEGO}", f"--N_rand={n_rand}", f"--n_iters={n}",
                    f"--fuse_steps={k}", f"--i_print={fuse}", "--i_img=0", "--i_weights=0",
                    "--i_testset=0", "--i_video=0", "--data_axis=1", f"--basedir={basedir}"])
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    train(cfg, scene, device=dev)
                walls[n].append(time.perf_counter() - t0)
            short, long = (float(np.median(walls[n][-2:])) for n in (SHORT, LONG))
            out[n_rand][name] = 1e3 * (long - short) / (LONG - SHORT)
    return out


def main() -> int:
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    ms = measure(white_views(), dev)
    print(json.dumps({"card": card, "fuse_steps": FUSE, "steps": LONG - SHORT,
                      "ms_per_step": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
