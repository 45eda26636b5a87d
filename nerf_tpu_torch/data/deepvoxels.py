"""DeepVoxels dataset loader (ref load_deepvoxels.py:6-108).

Counterpart of nerf_tpu/data/deepvoxels.py, its PNGs read with
``utils/io.py::read_png``. Parses intrinsics.txt, per-file 4x4 poses with
the (y,z)-negating axis flip, the train/validation/test directory
structure, and the hemisphere-radius near/far policy of the reference's
run_nerf.py:602-604.
"""

from __future__ import annotations

import os

import numpy as np

from nerf_tpu_torch.data.scene import Scene, default_intrinsics
from nerf_tpu_torch.utils.io import read_png


def parse_intrinsics(filepath: str, trgt_sidelength: int, invert_y: bool = False):
    """Parse a DeepVoxels ``intrinsics.txt``.

    Fixed 5-or-6-line format (semantics per ref load_deepvoxels.py:10-45):
    ``f cx cy [...]`` / grid barycenter / near plane / scale / ``H W`` /
    optional world2cam flag. Focal and principal point are rescaled to the
    target render side length (focal by height, cx/cy by their own axes).
    """
    lines = [ln.split() for ln in open(filepath).read().splitlines()]
    f, cx, cy = (float(v) for v in lines[0][:3])
    grid_barycenter = np.array([float(v) for v in lines[1]])
    near_plane = float(lines[2][0])
    scale = float(lines[3][0])
    height, width = (float(v) for v in lines[4])
    world2cam_poses = bool(int(lines[5][0])) if len(lines) > 5 and lines[5] else False

    f = f * trgt_sidelength / height
    cx = cx * trgt_sidelength / width
    cy = cy * trgt_sidelength / height
    fy = -f if invert_y else f
    full_intrinsic = np.diag([f, fy, 1.0, 1.0])
    full_intrinsic[:2, 2] = [cx, cy]
    return full_intrinsic, grid_barycenter, scale, near_plane, world2cam_poses


def _load_pose(filename: str) -> np.ndarray:
    nums = open(filename).read().split()
    return np.array([float(x) for x in nums]).reshape([4, 4]).astype(np.float32)


_FLIP = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]]
)


def _dir2poses(posedir: str) -> np.ndarray:
    poses = np.stack(
        [
            _load_pose(os.path.join(posedir, f))
            for f in sorted(os.listdir(posedir))
            if f.endswith("txt")
        ],
        0,
    )
    poses = poses @ _FLIP
    return poses[:, :3, :4].astype(np.float32)


def _load_images(imgdir: str, skip: int = 1) -> np.ndarray:
    files = [f for f in sorted(os.listdir(imgdir)) if f.endswith("png")]
    return np.stack(
        [read_png(os.path.join(imgdir, f)) / 255.0 for f in files[::skip]], 0
    ).astype(np.float32)


def load_dv_data(scene: str = "cube", basedir: str = "/data/deepvoxels", testskip: int = 8):
    """Reference-signature loader: (imgs, poses, render_poses, [H,W,focal], i_split)."""
    H = W = 512
    base = os.path.join(basedir, "train", scene)
    full_intrinsic, *_ = parse_intrinsics(os.path.join(base, "intrinsics.txt"), H)
    focal = full_intrinsic[0, 0]

    poses = _dir2poses(os.path.join(base, "pose"))
    testposes = _dir2poses(os.path.join(basedir, "test", scene, "pose"))[::testskip]
    valposes = _dir2poses(os.path.join(basedir, "validation", scene, "pose"))[::testskip]

    imgs = _load_images(os.path.join(base, "rgb"))
    testimgs = _load_images(os.path.join(basedir, "test", scene, "rgb"), testskip)
    valimgs = _load_images(os.path.join(basedir, "validation", scene, "rgb"), testskip)

    all_imgs = [imgs, valimgs, testimgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]

    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate([poses, valposes, testposes], 0)
    return imgs, poses, testposes, [H, W, focal], i_split


def load_deepvoxels_scene(basedir: str, shape: str = "greek", testskip: int = 8) -> Scene:
    """Scene-shaped loader with hemisphere near/far (ref run_nerf.py:602-604)."""
    imgs, poses, render_poses, hwf, i_split = load_dv_data(shape, basedir, testskip)
    H, W, focal = hwf
    hemi_r = float(np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1)))
    return Scene(
        images=imgs[..., :3].astype(np.float32),
        poses=poses[:, :3, :4],
        render_poses=render_poses,
        hwf=(int(H), int(W), float(focal)),
        K=default_intrinsics(int(H), int(W), float(focal)),
        i_train=i_split[0],
        i_val=i_split[1],
        i_test=i_split[2],
        near=hemi_r - 1.0,
        far=hemi_r + 1.0,
    )
