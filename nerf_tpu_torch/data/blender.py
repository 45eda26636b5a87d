"""Blender synthetic dataset loader (ref load_blender.py:37-89).

Counterpart of nerf_tpu/data/blender.py: reads ``transforms_{train,val,
test}.json`` and the PNGs (with ``utils/io.py::read_png``), keeps RGBA,
builds the 40-pose spherical render path, optionally halves the resolution
by 2x2 area averaging, and composites the background into the common
``Scene`` (ref run_nerf.py:577-580), with near/far 2/6.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_tpu_torch.data.scene import Scene, default_intrinsics
from nerf_tpu_torch.geom.poses import spherical_render_poses
from nerf_tpu_torch.utils.io import read_png


def _area_resize_half(img: np.ndarray) -> np.ndarray:
    """2x area downsample (cv2.INTER_AREA at factor 2, ref
    load_blender.py:82-84): the mean over 2x2 blocks."""
    H, W = img.shape[:2]
    H2, W2 = H // 2, W // 2
    img = img[: H2 * 2, : W2 * 2]
    return img.reshape(H2, 2, W2, 2, -1).mean(axis=(1, 3))


def load_blender_data(basedir: str, half_res: bool = False, testskip: int = 1):
    """The reference's loader: (imgs RGBA in [0, 1], poses, render_poses,
    [H, W, focal], i_split)."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in metas[s]["frames"][::skip]:
            imgs.append(read_png(os.path.join(basedir, frame["file_path"] + ".png")))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)  # RGBA kept
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(np.array(poses).astype(np.float32))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(metas["test"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    render_poses = spherical_render_poses(40, -30.0, 4.0)
    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs = np.stack([_area_resize_half(im) for im in imgs], 0).astype(np.float32)
    return imgs, poses, render_poses, [H, W, focal], i_split


def load_blender_scene(
    basedir: str,
    half_res: bool = False,
    testskip: int = 1,
    white_bkgd: bool = False,
) -> Scene:
    """The blender scene with near/far 2/6 and RGBA compositing (ref
    run_nerf.py:569-580)."""
    imgs, poses, render_poses, hwf, i_split = load_blender_data(basedir, half_res, testskip)
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
        K=default_intrinsics(int(H), int(W), float(focal)),
        i_train=i_split[0],
        i_val=i_split[1],
        i_test=i_split[2],
        near=2.0,
        far=6.0,
    )
