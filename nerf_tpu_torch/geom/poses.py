"""Camera pose utilities (host-side numpy).

Spherical eval-path poses (ref load_blender.py:10-34, reused by
load_LINEMOD.py:10-34) and the LLFF pose pipeline (ref load_llff.py:120-240),
counterparts of nerf_tpu/geom/poses.py with the same numerics: batched
frames, linear solves in place of explicit inverses, the reference's
cross-product orders and tie-break constants.
"""

from __future__ import annotations

import numpy as np


# --- spherical poses (blender/LINEMOD render path) ---

def _trans_t(t):
    return np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_theta(th):
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """4x4 c2w on a sphere (degrees; ref load_blender.py:29-34)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip @ c2w


def spherical_render_poses(
    n: int = 40, phi: float = -30.0, radius: float = 4.0
) -> np.ndarray:
    """The reference's 40-pose orbit: theta in [-180,180) (load_blender.py:75)."""
    return np.stack(
        [
            pose_spherical(angle, phi, radius)
            for angle in np.linspace(-180, 180, n + 1)[:-1]
        ],
        0,
    )


# --- LLFF pose pipeline (ref load_llff.py:120-240) ---

def _unit(x: np.ndarray) -> np.ndarray:
    """Normalize along the last axis (works batched)."""
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def _camera_frames(forward, up_hint, origin) -> np.ndarray:
    """Batched right-handed camera frames [..., 3, 4].

    Gram-Schmidt with the LLFF convention (ref viewmatrix, load_llff.py:128):
    columns are [right, up, forward, origin] with right = up_hint x forward.
    """
    fwd = _unit(forward)
    right = _unit(np.cross(np.broadcast_to(up_hint, fwd.shape), fwd))
    up = _unit(np.cross(fwd, right))
    return np.stack([right, up, fwd, np.broadcast_to(origin, fwd.shape)], -1)


def viewmatrix(z, up, pos) -> np.ndarray:
    """Single [3, 4] camera frame from forward z, up hint, and position."""
    return _camera_frames(np.asarray(z, float), np.asarray(up, float),
                          np.asarray(pos, float))


def _to_hom(p34: np.ndarray) -> np.ndarray:
    """[..., 3, 4] -> [..., 4, 4] with a [0,0,0,1] bottom row."""
    bottom = np.zeros(p34.shape[:-2] + (1, 4), p34.dtype)
    bottom[..., 0, 3] = 1.0
    return np.concatenate([p34, bottom], -2)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """Average pose of a set (ref load_llff.py:140-149). poses: [N, 3, 5].

    Forward = renormalized sum of per-pose forward axes; up hint = summed up
    axes; origin = mean translation; hwf column carried from pose 0.
    """
    frame = _camera_frames(
        poses[:, :3, 2].sum(0), poses[:, :3, 1].sum(0), poses[:, :3, 3].mean(0)
    )
    return np.concatenate([frame, poses[0, :3, -1:]], 1)


def render_path_spiral(
    c2w: np.ndarray,
    up: np.ndarray,
    rads: np.ndarray,
    focal: float,
    zdelta: float,
    zrate: float,
    rots: int,
    N: int,
) -> list:
    """Spiral eval path for forward-facing scenes (ref load_llff.py:153-162).

    All N cameras are built in one batch: Lissajous offsets in the average
    camera's frame, every camera looking through the point ``focal`` units
    down the average view axis. ``zdelta`` is accepted-but-unused exactly
    like the reference's.
    """
    del zdelta
    thetas = np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]
    radii = np.concatenate([np.asarray(rads, float), [1.0]])
    offsets = radii * np.stack(
        [
            np.cos(thetas),
            -np.sin(thetas),
            -np.sin(thetas * zrate),
            np.ones_like(thetas),
        ],
        -1,
    )  # [N, 4] homogeneous points in the avg-camera frame
    centers = offsets @ c2w[:3, :4].T  # [N, 3] world positions
    look_at = c2w[:3, :4] @ np.array([0.0, 0.0, -focal, 1.0])
    frames = _camera_frames(centers - look_at, up, centers)  # batched [N, 3, 4]
    hwf = np.broadcast_to(c2w[:3, 4:5], frames[:, :, :1].shape)
    return list(np.concatenate([frames, hwf], -1))


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Re-express all poses relative to their average (ref load_llff.py:166-178)."""
    avg = _to_hom(poses_avg(poses)[None, :3, :4])  # [1, 4, 4]
    rel = np.linalg.solve(avg, _to_hom(poses[:, :3, :4]))
    out = poses.copy()
    out[:, :3, :4] = rel[:, :3, :4]
    return out


def _closest_point_to_axes(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Least-squares 3D point nearest all camera view axes.

    Minimizes sum_i ||(I - d_i d_i^T)(p - o_i)||^2 via the same normal
    equations the reference forms (load_llff.py:188-196): solve
    mean(A_i^T A_i) p = -mean(b_i) with A_i the perpendicular projector and
    b_i = -A_i o_i.
    """
    proj = np.eye(3) - dirs[:, :, None] * dirs[:, None, :]  # [N, 3, 3]
    lhs = np.einsum("nij,nik->njk", proj, proj).mean(0)
    rhs = -np.einsum("nij,nj->ni", proj, origins).mean(0)
    return -np.linalg.solve(lhs, rhs)


def spherify_poses(poses: np.ndarray, bds: np.ndarray):
    """Rescale/reorient 360-degree captures onto a unit-ish sphere and build
    a 120-pose circular render path (ref load_llff.py:184-240)."""
    center = _closest_point_to_axes(poses[:, :3, 3], poses[:, :3, 2])

    # world frame centered at the focus point, z along the mean camera
    # offset; [0.1, 0.2, 0.3] is the reference's deterministic tie-break
    # vector for the remaining in-plane orientation (load_llff.py:202)
    zaxis = _unit((poses[:, :3, 3] - center).mean(0))
    xaxis = _unit(np.cross([0.1, 0.2, 0.3], zaxis))
    yaxis = _unit(np.cross(zaxis, xaxis))
    world = _to_hom(np.stack([xaxis, yaxis, zaxis, center], 1)[None])

    reset = np.linalg.solve(world, _to_hom(poses[:, :3, :4]))[:, :3, :4]

    # rescale so cameras sit at unit RMS distance from the focus point
    scale = 1.0 / np.sqrt(np.square(reset[:, :3, 3]).sum(-1).mean())
    reset[:, :3, 3] *= scale
    bds = bds * scale

    # circular path at the mean camera height; after rescaling the RMS
    # camera distance is exactly 1, so the circle radius is sqrt(1 - zh^2)
    zh = reset[:, :3, 3].mean(0)[2]
    radcircle = np.sqrt(1.0 - zh**2)
    thetas = np.linspace(0.0, 2.0 * np.pi, 120)
    cams = np.stack(
        [radcircle * np.cos(thetas), radcircle * np.sin(thetas),
         np.full_like(thetas, zh)],
        -1,
    )  # [120, 3]

    # the reference's circle frame is NOT viewmatrix's: with fwd = unit(cam)
    # and up = [0,0,-1] it takes right = fwd x up, then up' = fwd x right —
    # a left-handed variant (load_llff.py:219-226). Reproduced exactly.
    fwd = _unit(cams)
    right = _unit(np.cross(fwd, np.array([0.0, 0.0, -1.0])))
    up = _unit(np.cross(fwd, right))
    circle = np.stack([right, up, fwd, cams], -1)  # [120, 3, 4]

    hwf0 = poses[0, :3, -1:]
    new_poses = np.concatenate(
        [circle, np.broadcast_to(hwf0, circle[:, :, :1].shape)], -1
    )
    poses_reset = np.concatenate(
        [reset, np.broadcast_to(hwf0, reset[:, :, :1].shape)], -1
    )
    return poses_reset, new_poses, bds
