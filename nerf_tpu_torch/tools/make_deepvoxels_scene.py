"""Write a procedural greek-analog scene in DeepVoxels format.

Counterpart of tools/make_deepvoxels_scene.py:
``{train,validation,test}/greek_synth/`` with per-split ``pose/`` files
(flattened 4x4 matrices), ``rgb/`` PNGs and a train-split
``intrinsics.txt``, the layout load_dv_data reads (ref
load_deepvoxels.py:6-108), so ``configs/synth_dv.txt`` trains on it through
the DeepVoxels loader: the hemisphere near/far (ref run_nerf.py:602-604),
the (y,z)-negating pose flip and testskip. The analytic field
(``data/synth.py``, seed 7) is scaled by 0.5 into the unit ball; cameras
lie on a radius-2 upper hemisphere (seed 77), so near/far = (1, 3). From
the repository root, on the card:

    python -m nerf_tpu_torch.tools.make_deepvoxels_scene

writes ``data/deepvoxels`` (40 / 10 / 10 views at 512x512).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

from nerf_tpu_torch.data.synth import make_field, render_gt_image, save_gt_png, scale_field
from nerf_tpu_torch.device import DeviceLike
from nerf_tpu_torch.geom.poses import pose_spherical

RES = 512  # the loader (and the reference's) takes H = W = 512
RADIUS = 2.0  # hemisphere radius -> near/far = (1, 3) via the hemisphere policy
FOCAL = 655.0  # ~53 deg fov at 512px, greek-like framing
# pose-file convention: the loader right-multiplies by the (y,z)-negating
# flip (ref load_deepvoxels.py:70); FLIP is involutive, so writing
# pose_gl @ FLIP makes the loader recover exactly pose_gl
FLIP = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])
COUNTS = {"train": 40, "validation": 10, "test": 10}
OUT = os.path.join("data", "deepvoxels")


def write_scene(out: str, counts: Optional[Dict[str, int]] = None, res: int = RES,
                device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Write ``counts`` views a split (the tool's 40 / 10 / 10 by default)
    at ``res`` x ``res`` (the focal length scales with it) under ``out``,
    rendered on ``device`` (the card unless told otherwise). Returns each
    split's [n, 4, 4] OpenGL poses."""
    counts = COUNTS if counts is None else counts
    focal = FOCAL * res / RES
    # scale 0.5: centers within 0.43, +3 sigma of the biggest lobes ~ 0.9,
    # inside the [near, far] = [1, 3] marching band
    fp = scale_field(make_field(seed=7), 0.5)
    rng = np.random.default_rng(77)
    t0 = time.time()
    written = {}
    for split, n in counts.items():
        base = os.path.join(out, split, "greek_synth")
        os.makedirs(os.path.join(base, "pose"), exist_ok=True)
        os.makedirs(os.path.join(base, "rgb"), exist_ok=True)
        if split == "train":
            with open(os.path.join(base, "intrinsics.txt"), "w") as f:
                f.write(
                    f"{focal} {res/2:.1f} {res/2:.1f} 0.\n"
                    "0. 0. 0.\n0.\n1.\n"
                    f"{res} {res}\n0\n"
                )
        poses = []
        for i in range(n):
            theta = rng.uniform(-180.0, 180.0)
            phi = rng.uniform(-85.0, -5.0)  # upper hemisphere
            pose_gl = np.asarray(pose_spherical(theta, phi, RADIUS))
            with open(os.path.join(base, "pose", f"{i:05d}.txt"), "w") as f:
                f.write(" ".join(f"{x:.8f}" for x in (pose_gl @ FLIP).reshape(-1)))
            img = render_gt_image(fp, res, res, focal, pose_gl, near=1.0, far=3.0,
                                  device=device)
            save_gt_png(os.path.join(base, "rgb", f"{i:05d}.png"), img)
            poses.append(pose_gl)
            print(f"{split} {i+1}/{n}  ({time.time()-t0:.0f}s)", flush=True)
        written[split] = np.asarray(poses).reshape(-1, 4, 4)
    return written


def main() -> None:
    write_scene(OUT)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
