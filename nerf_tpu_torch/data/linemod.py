"""LINEMOD dataset loader (ref load_LINEMOD.py:37-93).

Counterpart of nerf_tpu/data/linemod.py, its PNGs read with
``utils/io.py::read_png``. Blender-style transforms json with absolute file
paths, a full per-frame
``intrinsic_matrix`` K, and json-provided near/far (floored/ceiled across
train/test metas).
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_tpu_torch.data.blender import _area_resize_half
from nerf_tpu_torch.data.scene import Scene
from nerf_tpu_torch.geom.poses import spherical_render_poses
from nerf_tpu_torch.utils.io import read_png


def load_LINEMOD_data(basedir: str, half_res: bool = False, testskip: int = 1):
    """Reference-signature loader:
    (imgs, poses, render_poses, [H, W, focal], K, i_split, near, far)."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = frame["file_path"]
            if not os.path.isabs(fname):
                fname = os.path.join(basedir, fname)
            imgs.append(read_png(fname))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    K = np.array(metas["test"]["frames"][0]["intrinsic_matrix"], dtype=np.float32)
    focal = float(K[0][0])

    render_poses = spherical_render_poses(40, -30.0, 4.0)

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs = np.stack(
            [_area_resize_half(im[..., :3]) for im in imgs], 0
        ).astype(np.float32)

    near = float(np.floor(min(metas["train"]["near"], metas["test"]["near"])))
    far = float(np.ceil(max(metas["train"]["far"], metas["test"]["far"])))
    return imgs, poses, render_poses, [H, W, focal], K, i_split, near, far


def load_linemod_scene(
    basedir: str, half_res: bool = False, testskip: int = 1, white_bkgd: bool = False
) -> Scene:
    """Scene-shaped loader with RGBA compositing (ref run_nerf.py:582-591)."""
    imgs, poses, render_poses, hwf, K, i_split, near, far = load_LINEMOD_data(
        basedir, half_res, testskip
    )
    if imgs.shape[-1] == 4:
        if white_bkgd:
            imgs = imgs[..., :3] * imgs[..., -1:] + (1.0 - imgs[..., -1:])
        else:
            imgs = imgs[..., :3]
    H, W, focal = hwf
    return Scene(
        images=imgs.astype(np.float32),
        poses=poses[:, :3, :4],
        render_poses=np.asarray(render_poses),
        hwf=(int(H), int(W), float(focal)),
        K=np.asarray(K, np.float32)[:3, :3],
        i_train=i_split[0],
        i_val=i_split[1],
        i_test=i_split[2],
        near=near,
        far=far,
    )
