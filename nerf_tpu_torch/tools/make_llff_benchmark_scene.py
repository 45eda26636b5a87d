"""Write the forward-facing procedural benchmark scene in LLFF format.

Counterpart of tools/make_llff_benchmark_scene.py: ``images/image*.png`` and
``poses_bounds.npy`` in the layout the reference downloads
(load_llff.py:62-118), so ``configs/synthff.txt`` drives the whole LLFF
pipeline: minify, recenter, NDC, use_batching, the spiral render path.
Cameras sit on a jittered grid near z = +4 looking down -z (seed 7) at the
analytic field with its backdrop wall (``data/synth.py``, seed 0), which
puts content on every ray, as a forward-facing photo has; the bounds are
the field's depth range. From the repository root, on the card:

    python -m nerf_tpu_torch.tools.make_llff_benchmark_scene

writes ``data/nerf_llff_data/synthff`` (24 views at 756x1008).
"""

from __future__ import annotations

import os
import time

import numpy as np

from nerf_tpu_torch.data.synth import make_field, render_gt_image, save_gt_png
from nerf_tpu_torch.device import DeviceLike

N_VIEWS = 24
H, W = 3024 // 4, 4032 // 4  # fern-shaped aspect at quarter res (756x1008)
FOCAL = 3260.5 / 4
OUT = os.path.join("data", "nerf_llff_data", "synthff")


def write_scene(out: str, n_views: int = N_VIEWS, hw=(H, W),
                device: DeviceLike = None) -> np.ndarray:
    """Write ``n_views`` views (the tool's 24 by default) at ``hw`` (the
    tool's 756x1008; the focal length scales with the width) under ``out``,
    rendered on ``device`` (the card unless told otherwise). Returns the
    [n_views, 3, 4] OpenGL camera-to-world poses."""
    h, w = hw
    focal = FOCAL * w / W
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    fp = make_field(seed=0, backdrop=True)
    rng = np.random.default_rng(7)

    poses_bounds = np.zeros((n_views, 17))
    c2ws = []
    t0 = time.time()
    for i in range(n_views):
        # OpenGL c2w (x right, y up, z backward), near-identity rotation with
        # small look-at jitter: a handheld forward-facing capture
        pos = np.array([
            rng.uniform(-0.45, 0.45), rng.uniform(-0.3, 0.3),
            4.0 + rng.uniform(-0.15, 0.15),
        ])
        look = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), 0.0])
        fwd = pos - look  # the camera looks down -z: its z axis points back
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        c2w = np.stack([right, up, fwd, pos], 1)  # [3, 4]

        img = render_gt_image(fp, h, w, focal, c2w, device=device)
        save_gt_png(os.path.join(out, "images", f"image{i:03d}.png"), img)

        # disk convention: [down, right, back] columns + hwf column (ref
        # load_llff.py:62-76 inverts this on load)
        m = np.concatenate(
            [-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:3], c2w[:, 3:4],
             np.array([[h], [w], [focal]])], 1
        )
        poses_bounds[i, :15] = m.reshape(-1)
        # depth bounds along the view axis: the field spans |p| < ~1.4
        poses_bounds[i, 15:] = [pos[2] - 1.6, pos[2] + 1.6]
        c2ws.append(c2w)
        print(f"view {i+1}/{n_views} ({time.time()-t0:.0f}s)", flush=True)

    np.save(os.path.join(out, "poses_bounds.npy"), poses_bounds)
    return np.asarray(c2ws).reshape(-1, 3, 4)


def main() -> None:
    write_scene(OUT)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
