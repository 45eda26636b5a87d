"""Write a procedural scene in LINEMOD format.

Counterpart of tools/make_linemod_scene.py: per-split
``transforms_{train,val,test}.json`` whose frames carry a per-frame
``intrinsic_matrix`` K and json ``near``/``far``, and the PNGs they name,
the layout load_LINEMOD_data reads (ref load_LINEMOD.py:37-93), so
``configs/synth_linemod.txt`` trains on it through the LINEMOD loader: the
json intrinsics and the near/far floor/ceil. Rendered from the analytic
field (``data/synth.py``, seed 11) on cameras at radius 4 (seed 111). From
the repository root, on the card:

    python -m nerf_tpu_torch.tools.make_linemod_scene

writes ``data/linemod_synth`` (30 / 6 / 6 views at 400x400).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from nerf_tpu_torch.data.synth import make_field, render_gt_image, save_gt_png
from nerf_tpu_torch.device import DeviceLike
from nerf_tpu_torch.geom.poses import pose_spherical

RES = 400
FOCAL = 520.0  # ~42 deg fov at 400px
COUNTS = {"train": 30, "val": 6, "test": 6}
OUT = os.path.join("data", "linemod_synth")


def write_scene(out: str, counts: Optional[Dict[str, int]] = None, res: int = RES,
                device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Write ``counts`` views a split (the tool's 30 / 6 / 6 by default) at
    ``res`` x ``res`` (the focal length scales with it) under ``out``,
    rendered on ``device`` (the card unless told otherwise). Returns each
    split's [n, 4, 4] poses."""
    counts = COUNTS if counts is None else counts
    focal = FOCAL * res / RES
    fp = make_field(seed=11)
    rng = np.random.default_rng(111)
    K = [[focal, 0.0, res / 2], [0.0, focal, res / 2], [0.0, 0.0, 1.0]]
    t0 = time.time()
    written = {}
    for split, n in counts.items():
        frames, poses = [], []
        os.makedirs(os.path.join(out, split), exist_ok=True)
        for i in range(n):
            theta = rng.uniform(-180.0, 180.0)
            phi = rng.uniform(-80.0, -10.0)
            pose = np.asarray(pose_spherical(theta, phi, 4.0))
            img = render_gt_image(fp, res, res, focal, pose, device=device)
            save_gt_png(os.path.join(out, split, f"r_{i}.png"), img)
            frames.append({
                "file_path": f"./{split}/r_{i}.png",
                "transform_matrix": pose.tolist(),
                "intrinsic_matrix": K,
            })
            poses.append(pose)
            print(f"{split} {i+1}/{n}  ({time.time()-t0:.0f}s)", flush=True)
        meta = {"frames": frames, "near": 2.0, "far": 6.0}
        with open(os.path.join(out, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
        written[split] = np.asarray(poses).reshape(-1, 4, 4)
    return written


def main() -> None:
    write_scene(OUT)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
