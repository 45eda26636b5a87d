"""Write the multi-scene training scenes in blender format.

Counterpart of tools/make_multi_scenes.py: S variants of the procedural
field, scene k from ``make_field(seed=200 + k)`` (``data/synth.py``) with
its cameras at radius 4 drawn from ``default_rng(1000 + k)``, at 200 x 200
with 15 / 3 / 3 views, under ``data/nerf_synthetic/multi_{k}``: the
datadirs of configs/multi/scene_{k}.txt, which this tool does not write
(they are in the repository). From the repository root, on the card:

    python -m nerf_tpu_torch.tools.make_multi_scenes [--scenes 8]
    python -m nerf_tpu_torch.cli.train_multi --configs configs/multi/scene_*.txt
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from nerf_tpu_torch.data.synth import make_field, render_gt_image, save_gt_png
from nerf_tpu_torch.device import DeviceLike
from nerf_tpu_torch.geom.poses import pose_spherical
from nerf_tpu_torch.tools.make_benchmark_scene import CAMERA_ANGLE_X

RES = 200
COUNTS = {"train": 15, "val": 3, "test": 3}
ROOT = os.path.join("data", "nerf_synthetic")


def write_scenes(root: str, n_scenes: int = 8, counts: Optional[Dict[str, int]] = None,
                 res: int = RES, device: DeviceLike = None) -> List[Dict[str, np.ndarray]]:
    """Write scenes 0 .. n_scenes-1 under ``root``/multi_{k}, ``counts``
    views a split (the tool's 15 / 3 / 3 by default) at ``res`` x ``res``,
    rendered on ``device`` (the card unless told otherwise). Returns each
    scene's poses by split ([n, 4, 4])."""
    counts = COUNTS if counts is None else counts
    focal = 0.5 * res / np.tan(0.5 * CAMERA_ANGLE_X)
    t0 = time.time()
    written = []
    for k in range(n_scenes):
        fp = make_field(seed=200 + k)
        rng = np.random.default_rng(1000 + k)
        out = os.path.join(root, f"multi_{k}")
        poses_by_split = {}
        for split, n in counts.items():
            frames, poses = [], []
            os.makedirs(os.path.join(out, split), exist_ok=True)
            for i in range(n):
                theta = rng.uniform(-180.0, 180.0)
                phi = rng.uniform(-80.0, -10.0)
                pose = np.asarray(pose_spherical(theta, phi, 4.0))
                img = render_gt_image(fp, res, res, focal, pose, device=device)
                rgba = np.concatenate([img, np.ones_like(img[..., :1])], -1)
                rel = f"./{split}/r_{i}"
                save_gt_png(os.path.join(out, f"{rel}.png"), rgba)
                frames.append({"file_path": rel, "transform_matrix": pose.tolist()})
                poses.append(pose)
            with open(os.path.join(out, f"transforms_{split}.json"), "w") as f:
                json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
            poses_by_split[split] = np.asarray(poses).reshape(-1, 4, 4)
        written.append(poses_by_split)
        print(f"scene {k + 1}/{n_scenes}  ({time.time() - t0:.0f}s)", flush=True)
    return written


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n_scenes = 8
    if "--scenes" in argv:
        idx = argv.index("--scenes")
        if idx + 1 >= len(argv):
            raise SystemExit("--scenes requires a value, e.g. --scenes 8")
        n_scenes = int(argv[idx + 1])
    write_scenes(ROOT, n_scenes)
    print("wrote", n_scenes, "scenes under", ROOT)


if __name__ == "__main__":
    main()
