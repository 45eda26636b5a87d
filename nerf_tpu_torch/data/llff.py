"""LLFF (real forward-facing) dataset loader (ref load_llff.py:8-316).

Counterpart of nerf_tpu/data/llff.py: parses ``poses_bounds.npy``, fixes
the rotation columns, rescales by ``1/(bds.min()*bd_factor)``, recenters,
spherifies or builds the spiral render path, and picks the min-distance
holdout view; ``load_llff_scene`` adds the ``llffhold`` split and the NDC
bounds.

Images are read with ``utils/io.py::read_png``, so only PNG loads: a
reference scene's ``images/`` holds JPEGs, and its ``images_{factor}/``
(what the reference's ``mogrify -format png`` writes, load_llff.py:8-57)
holds PNGs, which load as they are. ``_minify`` writes ``images_{factor}/``
once, with Lanczos-3 (ImageMagick's default downscale filter) from the
native resampler (``native/resize.py``), as PNGs through ``write_png``. A
load that needs a JPEG raises ``ValueError`` naming it.
"""

from __future__ import annotations

import os

import numpy as np

from nerf_tpu_torch.data.scene import Scene, default_intrinsics
from nerf_tpu_torch.geom.poses import (
    normalize,
    poses_avg,
    recenter_poses,
    render_path_spiral,
    spherify_poses,
)
from nerf_tpu_torch.native import resize
from nerf_tpu_torch.utils.io import read_png, write_png

_IMG_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")


def _check_png(path: str) -> None:
    if not path.lower().endswith(".png"):
        imgdir, name = os.path.split(path)
        raise ValueError(
            f"{path}: only PNG images are read (no imaging package). Provide "
            f"{os.path.basename(imgdir)}/ as PNGs, e.g. `mogrify -format png "
            f"{name}` there, or images_<factor>/ as the reference's minify writes "
            "them (`mogrify -resize <100/factor>% -format png`)")


def _imread(path: str) -> np.ndarray:
    _check_png(path)
    return read_png(path)


def minify_downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Lanczos-3 downsample of one image by ``factor``, to the size
    ``mogrify -resize {100/factor}%`` gives (each side rounded to nearest)."""
    H, W = img.shape[:2]
    H2 = max(1, int(H / factor + 0.5))
    W2 = max(1, int(W / factor + 0.5))
    return resize.lanczos_resize(img, H2, W2)


def _minify(basedir: str, factor: int) -> str:
    """Write ``images_{factor}/`` once (ref _minify, load_llff.py:8-57,
    without the ImageMagick/cp/rm subprocesses)."""
    imgdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(imgdir):
        return imgdir
    srcdir = os.path.join(basedir, "images")
    files = sorted(f for f in os.listdir(srcdir) if f.endswith(_IMG_EXTS))
    for f in files:  # a JPEG raises before anything is written
        _check_png(os.path.join(srcdir, f))
    tmpdir = f"{imgdir}.{os.getpid()}.tmp"
    os.makedirs(tmpdir)
    for f in files:
        small = minify_downsample(_imread(os.path.join(srcdir, f)), factor)
        write_png(os.path.join(tmpdir, os.path.splitext(f)[0] + ".png"),
                  np.clip(np.round(small), 0, 255).astype(np.uint8))
    os.replace(tmpdir, imgdir)
    return imgdir


def _load_data(basedir: str, factor: int = None):
    """ref _load_data (load_llff.py:62-118): poses [3,5,N], bds [2,N], imgs."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    if factor is not None and factor != 1:
        imgdir = _minify(basedir, factor)
    else:
        factor = 1
        imgdir = os.path.join(basedir, "images")

    imgfiles = [
        os.path.join(imgdir, f)
        for f in sorted(os.listdir(imgdir))
        if f.endswith(_IMG_EXTS)
    ]
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}"
        )

    raw = [_imread(f) for f in imgfiles]
    sh = raw[0].shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    imgs = [im[..., :3] / 255.0 for im in raw]  # float64, as nerf_tpu's
    imgs = np.stack(imgs, -1)
    return poses, bds, imgs


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
    path_zflat: bool = False,
):
    """Reference-signature loader (images, poses[.., 3, 5], bds, render_poses,
    i_test) — semantics of load_llff_data, load_llff.py:243-316."""
    poses, bds, imgs = _load_data(basedir, factor=factor)

    # fix rotation ordering: [down, right, back] -> [right, up, back]
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = normalize(poses[:, :3, 1].sum(0))
        # focus depth + spiral radii heuristics (load_llff.py:277-287)
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        zdelta = close_depth * 0.2
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        N_views, N_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots = 1
            N_views //= 2
        render_poses = render_path_spiral(
            c2w_path, up, rads, focal, zdelta, zrate=0.5, rots=N_rots, N=N_views
        )

    render_poses = np.array(render_poses).astype(np.float32)

    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))  # min-distance holdout (load_llff.py:309-311)

    return images.astype(np.float32), poses.astype(np.float32), bds, render_poses, i_test


def load_llff_scene(
    basedir: str,
    factor: int = 8,
    spherify: bool = False,
    llffhold: int = 8,
    no_ndc: bool = False,
    bd_factor: float = 0.75,
) -> Scene:
    """Scene-shaped loader with the reference's split/bounds policy
    (run_nerf.py:541-567): every ``llffhold``-th view held out (else the
    min-distance view), near/far 0/1 under NDC, else from the bounds."""
    images, poses, bds, render_poses, i_test = load_llff_data(
        basedir, factor, recenter=True, bd_factor=bd_factor, spherify=spherify
    )
    hwf = poses[0, :3, -1]
    poses = poses[:, :3, :4]

    i_test_arr = np.array([i_test])
    if llffhold > 0:
        i_test_arr = np.arange(images.shape[0])[::llffhold]
    i_val = i_test_arr
    i_train = np.array(
        [i for i in np.arange(images.shape[0]) if i not in i_test_arr and i not in i_val]
    )

    if no_ndc:
        near, far = float(bds.min() * 0.9), float(bds.max() * 1.0)
    else:
        near, far = 0.0, 1.0

    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    return Scene(
        images=images,
        poses=poses,
        render_poses=np.asarray(render_poses)[:, :3, :4],
        hwf=(H, W, focal),
        K=default_intrinsics(H, W, focal),
        i_train=i_train,
        i_val=i_val,
        i_test=i_test_arr,
        near=near,
        far=far,
        bds=bds,
    )
