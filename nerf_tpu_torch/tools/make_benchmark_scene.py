"""Write the procedural benchmark scene in blender format.

Counterpart of tools/make_benchmark_scene.py: ``{train,val,test}/r_*.png``
(RGBA, alpha 1) and ``transforms_*.json`` laid out like the reference's lego
download (load_blender.py:37-60), rendered from the analytic field
(``data/synth.py``, seed 0) on cameras at radius 4 (poses seed 42), so
``configs/synth.txt`` trains on it through the blender loader. From the
repository root, on the card:

    python -m nerf_tpu_torch.tools.make_benchmark_scene [--half]   # --half: 400x400

writes ``data/nerf_synthetic/synth`` (100 / 13 / 25 views at 800x800).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

from nerf_tpu_torch.data.synth import make_field, render_gt_image, save_gt_png
from nerf_tpu_torch.device import DeviceLike
from nerf_tpu_torch.geom.poses import pose_spherical

CAMERA_ANGLE_X = 0.6911112070083618  # lego's fov -> focal ~1111 at 800px
COUNTS = {"train": 100, "val": 13, "test": 25}
OUT = os.path.join("data", "nerf_synthetic", "synth")


def write_scene(out: str, counts: Optional[Dict[str, int]] = None, res: int = 800,
                device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Write ``counts`` views a split (the tool's 100 / 13 / 25 by default)
    at ``res`` x ``res`` under ``out``, rendered on ``device`` (the card
    unless told otherwise). Returns each split's [n, 4, 4] poses."""
    counts = COUNTS if counts is None else counts
    focal = 0.5 * res / np.tan(0.5 * CAMERA_ANGLE_X)
    fp = make_field(seed=0)
    rng = np.random.default_rng(42)
    t_start = time.time()
    written = {}
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
            print(f"{split} {i+1}/{n}  ({time.time()-t_start:.0f}s)", flush=True)
        meta = {"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}
        with open(os.path.join(out, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
        written[split] = np.asarray(poses).reshape(-1, 4, 4)
    return written


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    write_scene(OUT, res=400 if "--half" in argv else 800)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
