"""Procedural scene with analytic ground truth, in PyTorch.

Counterpart of nerf_tpu/data/synth.py: a seeded field of sharp ellipsoid
density lobes (``make_field``, numpy, the same arrays bit for bit), with
albedo texture and a view-dependent specular term (``field_sigma_rgb``),
volume-rendered with the compositing formula the renderer implements (ref
run_nerf.py:262-305) onto a white background (``render_gt_rays``,
``render_gt_image``). The card has no dataset and no network; the scene
writers under ``nerf_tpu_torch/tools/`` write these renders as the four
scene formats, so training there runs against analytic ground truth.

The field is evaluated one primitive at a time into per-point sums, where
nerf_tpu broadcasts a ``[rays, samples, primitives, 3]`` tensor that XLA
fuses away (eager PyTorch would hold 8.4 GB of it for a 16,384-ray chunk of
384 samples on the 111-primitive backdrop field). Every operation is
elementwise over the points (sums over x, y, z written out), or a scan
along each ray's samples, so a ray's result does not depend on the chunk it
is rendered in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nerf_tpu_torch.data.scene import default_intrinsics
from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.geom.rays import get_rays_np
from nerf_tpu_torch.ops.sampling import linspace01
from nerf_tpu_torch.utils.io import write_png


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """A sum-of-ellipsoid-Gaussians radiance field (arrays are numpy)."""

    centers: np.ndarray  # [K, 3]
    inv_scales: np.ndarray  # [K, 3] (1/sigma per axis)
    amps: np.ndarray  # [K]
    colors: np.ndarray  # [K, 3]


# density tail cutoff: sigma = max(0, sum_k g_k - TAU). Gaussians never reach
# zero; without the cutoff their tails tint the whole frustum and there is no
# clean white background for the white_bkgd recipe to composite against.
SIGMA_TAU = 3.0


def make_field(seed: int = 0, n_prims: int = 48, backdrop: bool = False) -> FieldParams:
    rng = np.random.default_rng(seed)
    # centers in a ball of radius 0.85: with scales <= 0.25 and the TAU
    # cutoff the object stays inside the ~1.4 half-extent the lego-fov
    # camera sees at radius 4, leaving visible white background
    dirs = rng.standard_normal((n_prims, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radii = 0.85 * rng.uniform(0.0, 1.0, (n_prims, 1)) ** (1 / 3)
    centers = dirs * radii
    scales = rng.uniform(0.05, 0.18, (n_prims, 3))
    scales[: n_prims // 6] = rng.uniform(0.2, 0.3, (n_prims // 6, 3))
    amps = rng.uniform(60.0, 160.0, n_prims)
    # saturated base colors
    colors = rng.uniform(0.0, 1.0, (n_prims, 3))
    colors = 0.15 + 0.85 * colors / colors.max(axis=-1, keepdims=True)

    if backdrop:
        # A dense wall of flattened Gaussians at z = -1.45, wide enough to
        # fill the forward-facing frustum. Why: the fern recipe composites
        # empty space to BLACK (no white_bkgd, configs/fern.txt), so a scene
        # whose GT is composited on white leaves ~60% of pixels physically
        # unexplainable and BOTH this framework and the live reference
        # collapse to a ~16.7 dB white-haze fit on it (measured,
        # CONVERGENCE.md). A real forward-facing photo has content on every
        # ray; the wall reproduces that property. Pastel per-tile albedo +
        # the global texture term give the wall learnable structure.
        gx, gy = np.meshgrid(np.arange(-4, 5) * 0.85, np.arange(-3, 4) * 0.8)
        n_wall = gx.size
        wall_centers = np.stack(
            [gx.ravel(), gy.ravel(), np.full(n_wall, -1.45)], -1
        )
        wall_scales = np.tile(np.array([[0.55, 0.52, 0.06]]), (n_wall, 1))
        wall_amps = np.full(n_wall, 300.0)
        wall_colors = 0.72 + 0.26 * rng.uniform(0.0, 1.0, (n_wall, 3))
        centers = np.concatenate([centers, wall_centers], 0)
        scales = np.concatenate([scales, wall_scales], 0)
        amps = np.concatenate([amps, wall_amps], 0)
        colors = np.concatenate([colors, wall_colors], 0)

    return FieldParams(
        centers=centers.astype(np.float32),
        inv_scales=(1.0 / scales).astype(np.float32),
        amps=amps.astype(np.float32),
        colors=colors.astype(np.float32),
    )


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """v [..., 3] summed over its last axis, [..., 1], as x + y + z: no
    reduction kernel, whose order may change with the number of rows."""
    return v[..., 0:1] + v[..., 1:2] + v[..., 2:3]


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_sum3(v * v))


def field_sigma_rgb(fp: FieldParams, pts: torch.Tensor, viewdirs: torch.Tensor):
    """Analytic (sigma, rgb) at ``pts`` [..., 3] seen along ``viewdirs`` [..., 3],
    on ``pts``'s device.

    sigma = max(0, sum_k g_k - SIGMA_TAU) with g_k = amp_k exp(-|d_k|^2 / 2),
    d_k = (p - c_k) / s_k; rgb = the g-weighted albedo, modulated by a
    two-octave sinusoidal texture, plus a Blinn-style specular lobe off the
    density's analytic normal.
    """
    dev = pts.device
    p = pts.movedim(-1, 0).contiguous()  # [3, ...]: one launch for the 3 axes
    bcast = (-1, 3) + (1,) * (p.dim() - 1)  # [K, 3, 1, ...]
    centers = torch.as_tensor(fp.centers, device=dev).reshape(bcast)
    inv_s = torch.as_tensor(fp.inv_scales, device=dev).reshape(bcast)
    colors = torch.as_tensor(fp.colors, device=dev).reshape(bcast)
    g_sum = torch.zeros_like(p[0])
    grad, col = torch.zeros_like(p), torch.zeros_like(p)
    for k, amp in enumerate(fp.amps.tolist()):
        d = (p - centers[k]).mul_(inv_s[k])
        g = d[0] * d[0]
        g.addcmul_(d[1], d[1]).addcmul_(d[2], d[2])
        g.mul_(-0.5).exp_().mul_(amp)  # g_k = amp_k exp(-|d_k|^2 / 2)
        g_sum.add_(g)
        grad.addcmul_(g, d.mul_(-inv_s[k]))  # -sum_k g_k d_k / s_k
        col.addcmul_(g, colors[k])
    sigma = torch.clamp(g_sum - SIGMA_TAU, min=0.0)

    # analytic density gradient -> surface-ish normal
    grad = grad.movedim(0, -1)
    n = grad / (_norm3(grad) + 1e-6)
    albedo = col.movedim(0, -1) / (g_sum[..., None] + 1e-9)
    tex = 1.0 + 0.25 * _sum3(torch.sin(9.0 * pts)) * torch.cos(17.0 * pts[..., :1])
    spec = 0.35 * torch.clamp(_sum3(-viewdirs * n), min=0.0) ** 16
    rgb = torch.clamp(albedo * tex + spec, 0.0, 1.0)
    return sigma, rgb


def render_gt_rays(
    fp: FieldParams,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: float = 2.0,
    far: float = 6.0,
    n_samples: int = 384,
) -> torch.Tensor:
    """Volume render of the analytic field along rays [R, 3] onto white,
    [R, 3], on the rays' device: depths ``linspace(near, far, n_samples)``
    (as ``jnp.linspace`` computes it, within an ulp), dists scaled by
    ||rays_d|| with 1e10 last, alpha = 1 - exp(-sigma*dist), exclusive
    cumprod transmittance (+1e-10), white background (ref
    run_nerf.py:262-305)."""
    s = linspace01(n_samples, device=rays_o.device)
    t = near * (1.0 - s) + far * s
    pts = rays_o[..., None, :] + rays_d[..., None, :] * t[:, None]
    d_norm = _norm3(rays_d)
    vd = rays_d / d_norm
    sigma, rgb = field_sigma_rgb(fp, pts, vd[..., None, :].expand(pts.shape))
    dists = torch.cat([t[1:] - t[:-1], torch.full((1,), 1e10, device=t.device)])
    dists = dists * d_norm
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    w = alpha * trans
    # sums along each ray as the last element of a scan: its order is fixed
    # per ray, whatever the number of rays
    img = torch.cumsum(w[..., None] * rgb, dim=-2)[..., -1, :]
    acc = torch.cumsum(w, dim=-1)[..., -1:]
    return img + (1.0 - acc)  # white background


def scale_field(fp: FieldParams, s: float) -> FieldParams:
    """Geometrically scale a field by ``s``: Gaussian centers and extents
    scale exactly, amplitudes by 1/s, so that where the SIGMA_TAU cutoff is
    inactive optical depth is preserved. Not exact through the cutoff
    (sigma = max(0, G/s - TAU), not (1/s) max(0, G - TAU)); nerf_tpu's
    definition, kept so both packages write the same scenes."""
    return FieldParams(
        centers=(fp.centers * s).astype(np.float32),
        inv_scales=(fp.inv_scales / s).astype(np.float32),
        amps=(fp.amps / s).astype(np.float32),
        colors=fp.colors,
    )


def render_gt_image(
    fp: FieldParams, H: int, W: int, focal: float, c2w: np.ndarray,
    chunk: int = 65536, near: float = 2.0, far: float = 6.0,
    n_samples: int = 384, device: DeviceLike = None,
) -> np.ndarray:
    """One [H, W, 3] ground-truth view (numpy float32) for the camera
    ``c2w`` [3|4, 4], rendered in chunks of up to ``chunk`` rays (the last
    padded) on ``device``: the card unless told otherwise."""
    dev = resolve_device(device)
    K = default_intrinsics(H, W, focal)
    rays_o, rays_d = get_rays_np(H, W, K, np.asarray(c2w)[:3, :4])
    ro = rays_o.reshape(-1, 3)
    rd = rays_d.reshape(-1, 3)
    n = ro.shape[0]
    chunk = min(chunk, n)
    pad = (-n) % chunk
    ro = torch.as_tensor(np.concatenate([ro, np.zeros((pad, 3), np.float32)], 0), device=dev)
    rd = torch.as_tensor(np.concatenate([rd, np.ones((pad, 3), np.float32)], 0), device=dev)
    with torch.no_grad():
        out = [render_gt_rays(fp, ro[i : i + chunk], rd[i : i + chunk], near, far, n_samples)
               for i in range(0, n + pad, chunk)]
    return torch.cat(out, 0)[:n].reshape(H, W, 3).cpu().numpy()


def save_gt_png(path: str, img: np.ndarray) -> None:
    """Write a ground-truth view in [0, 1] as an 8-bit PNG, clipped and
    truncated (not rounded) to 8 bits, as nerf_tpu's scene writers do."""
    write_png(path, (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
