"""One kernel per level from rays to composited maps (``--fused_render``).

Counterpart of nerf_tpu/experimental/fused_render.py:

    (rays_o, rays_d, viewdirs, z_vals, noise)  ->  (rgb_map, disp, acc, weights)

- K5 (``nerf_fused_render_fwd`` in ``csrc/fused_render.cu``) runs K1's
  tile (``csrc/fwd_tile_sm90.cuh`` in bf16) over groups of whole rays and
  composites each group in the kernel: when serving, raw goes only to a
  per-CTA scratch slab in device memory, which stays in L2
  (``ray_groups`` and ``slab_floats`` size it);
- K6 (``fused_render_bwd``) is the compositing backward
  (``composite_bwd`` → ``nerf_fused_render_bwd_planes``, a warp per ray on
  K5's compositing scan, from the raw K5 kept under autograd) followed by
  K4's phases with a direction per ray: weight grads only. Rays, depths and noise get no gradient (nerf_tpu's module
  docstring: they are non-differentiated leaves of the training graph).

The pieces, as in ops/fused_mlp.py:
- ``fused_render_reference`` / ``fused_render_bwd_reference``: the plain
  PyTorch versions of K5 and K6. The compositing follows nerf_tpu's
  ``_composite`` (fused_render.py:122-152), not ops/compositing.py:
  ``c = exp(-relu(σ + noise)·dist) + 1e-10`` and the transmittance
  ``exp(Σ_{j<k} log c_j)`` in f32; the backward forms the cotangent of raw
  with ``_bwd_rule``'s hand formulas (:213-252), not autograd, so the
  ``live`` guard on depth/acc behaves as there;
- ``fused_render_fwd`` / ``fused_render_bwd``: the wrappers, with launch
  counters. A CPU tensor takes the plain version; a CUDA tensor launches
  the kernel or raises (at the wide family's configurations K5w,
  ``fused_render_wide_fwd``: K1w's raw planes, then K5's compositing as its
  own launch; and K6w, ``fused_render_wide_bwd``: K6's compositing pass,
  then K4w);
- ``fused_render_level``: the entry the renderer calls; under autograd it
  runs ``_FusedRender`` (K5 forward, K6 backward);
- the stacked (multi-scene) pair, ``fused_render_stacked_fwd`` /
  ``fused_render_stacked_bwd`` and ``fused_render_level_stacked``: S nets of
  one shape as leaves with a leading scene axis, one launch of K5
  (``nerf_fused_render_fwd_stacked``: its ray groups inside a scene a row
  of the grid) and of K6 (one compositing pass over every scene's rays,
  then the stacked K4, ``nerf_fused_mlp_bwd_stacked``) for every scene's
  rays; their plain versions apply K5's and K6's scene by scene.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import _build, fused_mlp, fused_mlp_wide
from nerf_tpu_torch.ops.compositing import RayOutputs
from nerf_tpu_torch.ops.fused_mlp import KP_NAMES


def supports(cfg: MLPConfig, pe_pts: PosEncConfig, pe_views, n_samples: int) -> bool:
    """The fused MLP's architectures, at sample counts that are multiples
    of 8 (nerf_tpu's guard). The W <= 256 tile runs K5 and K6 where
    ``fused_mlp.tile_supports``, the wide family K5w and K6w elsewhere."""
    return fused_mlp.supports(cfg, pe_pts, pe_views) and n_samples % 8 == 0


def supports_stacked(cfg: MLPConfig, pe_pts: PosEncConfig, pe_views, n_samples: int) -> bool:
    """The stacked K5's and K6's guard: ``supports`` (nerf_tpu runs its
    kernels under its vmap over the scenes wherever they run for one); the
    tile's stacked launches where ``fused_mlp.tile_supports``, K5ws and K6ws
    elsewhere."""
    return supports(cfg, pe_pts, pe_views, n_samples)


# K5's bf16 slab: a CTA's raw planes (r, g, b, sigma) of a ray group, in
# two buffers (csrc/fused_render.cu: RAW_PLANES, SLAB_BUFFERS)
SLAB_PLANES, SLAB_BUFFERS = 4, 2


def ray_groups(n_samples: int, tile: int = fused_mlp.FWD_TILE) -> Tuple[int, int]:
    """(G, n_sub) of K5's bf16 kernel: a group is G whole rays of
    ``n_samples``, which fill n_sub tiles of ``tile`` points, G·S = n_sub·tile
    = lcm(S, tile) (csrc/fused_render.cu ``ray_groups``)."""
    lcm = n_samples * tile // math.gcd(n_samples, tile)
    return lcm // n_samples, lcm // tile


def slab_floats(n_rays: int, n_samples: int, sms: int, scenes: int = 1) -> int:
    """Floats of K5's bf16 scratch slab for a launch without raw planes: a
    persistent grid of min(groups, sms) CTAs, each with SLAB_BUFFERS buffers
    of a group's SLAB_PLANES raw planes. The stacked K5 (``scenes`` > 1,
    n_rays a scene's, whole groups) has a slab for each CTA of its (x,
    scene) grid, min(groups a scene, max(1, sms // scenes)) CTAs a scene
    (csrc/fwd_tile_sm90.cuh ``scene_grid``)."""
    G, n_sub = ray_groups(n_samples)
    groups = -(-n_rays // G)
    grid = min(groups, sms) if scenes == 1 else min(groups, max(1, sms // scenes)) * scenes
    return grid * SLAB_BUFFERS * SLAB_PLANES * n_sub * fused_mlp.FWD_TILE


class Maps(NamedTuple):
    rgb: torch.Tensor  # [R, 3]
    disp: torch.Tensor  # [R]
    acc: torch.Tensor  # [R]
    w: torch.Tensor  # [R, S]
    raw: Optional[torch.Tensor]  # planes [4, R, S], K6's residual


def _composite(raw, rays_d, z_vals, noise, white_bkgd) -> Dict[str, torch.Tensor]:
    """nerf_tpu's in-kernel raw2outputs on raw planes [4, R, S]: the maps
    and the intermediates the backward reuses."""
    sigma = raw[3] if noise is None else raw[3] + noise
    dn = torch.sqrt(torch.sum(rays_d * rays_d, -1, keepdim=True))
    dz = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dz, torch.full_like(z_vals[:, :1], 1e10)], -1) * dn
    ealpha = torch.exp(-torch.relu(sigma) * dists)  # = 1 - alpha
    c = ealpha + 1e-10
    log_c = torch.log(c)
    trans = torch.exp(torch.cat([torch.zeros_like(log_c[:, :1]), log_c[:, :-1].cumsum(-1)], -1))
    w = (1.0 - ealpha) * trans
    rgbs = torch.sigmoid(raw[:3])  # [3, R, S]
    rgb_map = torch.sum(w * rgbs, -1).T
    depth = torch.sum(w * z_vals, -1)
    acc = torch.sum(w, -1)
    disp = 1.0 / torch.clamp(depth / acc, min=1e-10)  # an empty ray's NaN stays NaN
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc)[:, None]
    return {"rgb_map": rgb_map, "disp": disp, "acc": acc, "w": w, "sigma": sigma,
            "dists": dists, "ealpha": ealpha, "c": c, "trans": trans, "rgbs": rgbs,
            "depth": depth}


def fused_render_reference(kp, rays_o, rays_d, viewdirs, z_vals, noise,
                           white_bkgd: bool) -> Maps:
    """Plain PyTorch version of K5: the maps, and raw planes [4, R, S] from
    ``fused_mlp._forward`` (K1's plain version) beneath them, contiguous (the
    layout the compositing's vectorised exp and log see, and so their last
    bits, then follow the values alone)."""
    raw = fused_mlp.fused_rays_planes_reference(kp, rays_o, rays_d, viewdirs, z_vals).contiguous()
    cmp = _composite(raw, rays_d, z_vals, noise, white_bkgd)
    return Maps(cmp["rgb_map"], cmp["disp"], cmp["acc"], cmp["w"], raw)


def composite_bwd_reference(raw, rays_d, z_vals, noise, g_rgb, g_disp, g_acc, g_w,
                            white_bkgd: bool) -> torch.Tensor:
    """The cotangent of raw planes [4, R, S] from the maps' cotangents,
    by nerf_tpu's _bwd_rule formulas (fused_render.py:213-252)."""
    cmp = _composite(raw, rays_d, z_vals, noise, white_bkgd)
    w, c, trans, rgbs = cmp["w"], cmp["c"], cmp["trans"], cmp["rgbs"]
    depth, acc, disp = cmp["depth"], cmp["acc"], cmp["disp"]
    zero = torch.zeros_like(acc)
    # where() keeps the clamped and the empty ray's 0/0 branch out
    live = depth / acc > 1e-10
    dm = torch.where(live, -g_disp * disp * disp, zero)
    g_depth = torch.where(live, dm / acc, zero)
    g_acc_t = g_acc - torch.where(live, dm * depth / (acc * acc), zero)
    if white_bkgd:
        g_acc_t = g_acc_t - ((g_rgb[:, 0] + g_rgb[:, 1]) + g_rgb[:, 2])
    rgb_dot = g_rgb[:, 0:1] * rgbs[0] + g_rgb[:, 1:2] * rgbs[1] + g_rgb[:, 2:3] * rgbs[2]
    t_w = g_w + rgb_dot + g_depth[:, None] * z_vals + g_acc_t[:, None]
    # d/d alpha_k = t_k T_k - (sum_{i>k} t_i w_i) / c_k, the suffix summed from the back
    tw = t_w * w
    suffix = torch.cat([tw.flip(-1).cumsum(-1).flip(-1)[:, 1:], torch.zeros_like(tw[:, :1])], -1)
    d_alpha = t_w * trans - suffix / c
    d_sigma = d_alpha * cmp["ealpha"] * cmp["dists"] * (cmp["sigma"] > 0).float()
    d_rgb = w * rgbs * (1.0 - rgbs) * g_rgb.T[:, :, None]
    return torch.cat([d_rgb, d_sigma[None]], 0)


def fused_render_bwd_reference(kp, rays_o, rays_d, viewdirs, z_vals, noise, raw, g_rgb,
                               g_disp, g_acc, g_w, white_bkgd: bool) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of K6: float32 grads of every packed leaf
    (kp's shapes) from the maps' cotangents, through the compositing
    backward and K4's plain version (a direction per ray)."""
    g_planes = composite_bwd_reference(raw, rays_d, z_vals, noise, g_rgb, g_disp, g_acc, g_w,
                                       white_bkgd)
    return fused_mlp.fused_rays_planes_bwd_reference(kp, rays_o, rays_d, viewdirs, z_vals,
                                                     g_planes)


def _check(rays_o, rays_d, viewdirs, z_vals, noise, **per_ray) -> None:
    fused_mlp._check_rays(rays_o, rays_d, viewdirs, z_vals)
    R, S = z_vals.shape
    shapes = {"noise": (R, S), "raw": (4, R, S), "g_rgb": (R, 3), "g_disp": (R,),
              "g_acc": (R,), "g_w": (R, S)}
    for name, t in dict(per_ray, noise=noise).items():
        if t is None and name == "noise":
            continue
        if t.shape != shapes[name] or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 {shapes[name]}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != z_vals.device:
            raise ValueError(f"{name} is on {t.device}, z_vals on {z_vals.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_render_wide_fwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, white_bkgd, blobs,
                          keep_raw) -> Maps:
    """K5w on CUDA tensors, ``fused_render_fwd``'s arguments: K1w's
    launches into raw planes (ops/fused_mlp_wide.py), then one compositing
    launch (``nerf_fused_render_composite``, a warp per ray on K5's
    compositing, csrc/fused_render.cu); ``launches`` counts the calls."""
    raw = fused_mlp_wide.rays_planes(fused_mlp_wide._ops(kp, z_vals), kp, rays_o, rays_d,
                                     viewdirs, z_vals, blobs)
    out = launch_composite_maps(raw, rays_d, z_vals, noise, white_bkgd)
    fused_render_wide_fwd.launches += 1
    return out._replace(raw=raw if keep_raw else None)


fused_render_wide_fwd.launches = 0


def _launch_fwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, white_bkgd, blobs,
                keep_raw) -> Maps:
    if fused_mlp.is_wide(kp):
        return fused_render_wide_fwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, white_bkgd,
                                     blobs, keep_raw)
    lib = _build.load("fused_render")
    dtype, W, Fp, Fv = fused_mlp._kernel_config(kp, z_vals)
    dev = z_vals.device
    R, S = z_vals.shape
    f32 = dict(dtype=torch.float32, device=dev)
    out = Maps(torch.empty(R, 3, **f32), torch.empty(R, **f32), torch.empty(R, **f32),
               torch.empty(R, S, **f32), torch.empty(4, R, S, **f32) if keep_raw else None)
    if R * S == 0:
        return out
    ro, rd, vd, z = (t.contiguous() for t in (rays_o, rays_d, viewdirs, z_vals))
    nz = None if noise is None else noise.contiguous()
    wblob, bblob = fused_mlp.kernel_blobs(kp) if blobs is None else blobs
    slab = None  # the bf16 kernel's scratch where raw planes are not kept
    if dtype == torch.bfloat16 and not keep_raw:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slab = torch.empty(slab_floats(R, S, sms), **f32)
    with torch.cuda.device(dev):
        err = lib.nerf_fused_render_fwd(
            int(dtype == torch.bfloat16), W, ro.data_ptr(), rd.data_ptr(), vd.data_ptr(),
            z.data_ptr(), _ptr(nz), R, S, Fp, Fv, int(white_bkgd), wblob.data_ptr(),
            bblob.data_ptr(), *(_ptr(t) for t in out), _ptr(slab),
            0 if slab is None else slab.numel(), torch.cuda.current_stream(dev).cuda_stream,
        )
    fused_mlp._raise_on(lib, err, "fused_render_fwd")
    fused_render_fwd.launches += 1
    return out


def fused_render_fwd(kp: Dict[str, torch.Tensor], rays_o, rays_d, viewdirs, z_vals,
                     noise: Optional[torch.Tensor], white_bkgd: bool,
                     blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     keep_raw: bool = False) -> Maps:
    """The maps of one level from packed params, rays [R, 3], depths and
    sigma noise [R, S] (None: none); raw planes too with ``keep_raw``. CUDA
    tensors launch K5 (``launches`` counts them); CPU tensors take the plain
    version. ``blobs`` is ``fused_mlp.kernel_blobs(kp)`` where the caller
    keeps it across launches."""
    _check(rays_o, rays_d, viewdirs, z_vals, noise)
    if z_vals.device.type == "cpu":
        out = fused_render_reference(kp, rays_o, rays_d, viewdirs, z_vals, noise, white_bkgd)
        return out if keep_raw else out._replace(raw=None)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {z_vals.device}")
    return _launch_fwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, white_bkgd, blobs, keep_raw)


fused_render_fwd.launches = 0


def _launch_composite_bwd(raw, rays_d, z_vals, noise, g_rgb, g_disp, g_acc, g_w,
                          white_bkgd) -> torch.Tensor:
    """K6's first half on the card: ``composite_bwd_reference``'s cotangent
    planes [4, R, S] (``composite_bwd`` in csrc/fused_render.cu, a warp per
    ray; ``composite_bwd.launches`` counts the launches)."""
    lib = _build.load("fused_render")
    dev = z_vals.device
    R, S = z_vals.shape
    g_planes = torch.empty(4, R, S, dtype=torch.float32, device=dev)
    if R * S == 0:
        return g_planes
    args = [None if t is None else t.contiguous()
            for t in (rays_d, z_vals, noise, raw, g_rgb, g_disp, g_acc, g_w)]
    with torch.cuda.device(dev):
        err = lib.nerf_fused_render_bwd_planes(
            *(_ptr(t) for t in args), R, S, int(white_bkgd), g_planes.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    fused_mlp._raise_on(lib, err, "fused_render_bwd_planes")
    composite_bwd.launches += 1
    return g_planes


def composite_bwd(raw, rays_d, z_vals, noise: Optional[torch.Tensor], g_rgb, g_disp, g_acc, g_w,
                  white_bkgd: bool) -> torch.Tensor:
    """The cotangent of raw planes [4, R, S] from the maps' cotangents (K6's
    compositing pass, both precisions). CUDA tensors launch the kernel
    (``launches`` counts them); CPU tensors take ``composite_bwd_reference``."""
    # (_check's three ray arguments share rays_d's shape: it stands for all)
    _check(rays_d, rays_d, rays_d, z_vals, noise, raw=raw, g_rgb=g_rgb, g_disp=g_disp,
           g_acc=g_acc, g_w=g_w)
    args = (raw, rays_d, z_vals, noise, g_rgb, g_disp, g_acc, g_w, white_bkgd)
    if z_vals.device.type == "cpu":
        return composite_bwd_reference(*args)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no compositing kernel for device {z_vals.device}")
    return _launch_composite_bwd(*args)


composite_bwd.launches = 0


def fused_render_wide_bwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, raw, g_rgb, g_disp,
                          g_acc, g_w, white_bkgd, blobs=None) -> Dict[str, torch.Tensor]:
    """K6w on CUDA tensors: K6's compositing pass (``composite_bwd``,
    unchanged), then K4w's launches (``launches`` counts the calls)."""
    ops = fused_mlp_wide._ops(kp, z_vals)
    g_planes = _launch_composite_bwd(raw, rays_d, z_vals, noise, g_rgb, g_disp, g_acc, g_w,
                                     white_bkgd)
    grads = fused_mlp_wide.rays_planes_bwd(ops, kp, rays_o, rays_d, viewdirs, z_vals, g_planes,
                                           blobs)
    fused_render_wide_bwd.launches += 1
    return grads


fused_render_wide_bwd.launches = 0


def _launch_bwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, raw, g_rgb, g_disp, g_acc, g_w,
                white_bkgd, blobs) -> Dict[str, torch.Tensor]:
    if fused_mlp.is_wide(kp):
        return fused_render_wide_bwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, raw, g_rgb,
                                     g_disp, g_acc, g_w, white_bkgd, blobs)
    fused_mlp._kernel_config(kp, z_vals)
    g_planes = _launch_composite_bwd(raw, rays_d, z_vals, noise, g_rgb, g_disp, g_acc, g_w,
                                     white_bkgd)
    grads = fused_mlp._launch_bwd(kp, rays_o, rays_d, viewdirs, z_vals, g_planes, blobs)
    R, S = z_vals.shape
    if R * S:
        fused_render_bwd.launches += 1
    return grads


def fused_render_bwd(kp: Dict[str, torch.Tensor], rays_o, rays_d, viewdirs, z_vals,
                     noise: Optional[torch.Tensor], raw, g_rgb, g_disp, g_acc, g_w,
                     white_bkgd: bool,
                     blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
    """float32 grads of the packed leaves (kp's shapes) from the cotangents
    of ``fused_render_fwd``'s maps (g_rgb [R, 3], g_disp, g_acc [R], g_w
    [R, S]), given its raw planes. CUDA tensors launch K6, the compositing
    backward and then K4's phases (``launches`` counts the calls); CPU
    tensors take the plain version."""
    _check(rays_o, rays_d, viewdirs, z_vals, noise, raw=raw, g_rgb=g_rgb, g_disp=g_disp,
           g_acc=g_acc, g_w=g_w)
    args = (kp, rays_o, rays_d, viewdirs, z_vals, noise, raw, g_rgb, g_disp, g_acc, g_w,
            white_bkgd)
    if z_vals.device.type == "cpu":
        return fused_render_bwd_reference(*args)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {z_vals.device}")
    return _launch_bwd(*args, blobs)


fused_render_bwd.launches = 0


def _rays_slice(ts, a: int, b: int, dim: int = 0):
    """Rays a..b of each per-ray tensor (None stays None) along ``dim``:
    a slice of K6's backward (ops/fused_mlp.py::bwd_slices)."""
    return [None if t is None else t.narrow(dim, a, b - a) for t in ts]


class _FusedRender(torch.autograd.Function):
    """K5 forward, K6 backward over the packed leaves (in KP_NAMES order).
    Rays, depths and noise get no gradient (fused_render.py:20-24); each
    leaf's grad comes back in its own dtype, as in ``_FusedRaysPlanes``."""

    @staticmethod
    def forward(ctx, rays_o, rays_d, viewdirs, z_vals, noise, white_bkgd, *leaves):
        kp = dict(zip(KP_NAMES, leaves))
        blobs = fused_mlp.kernel_blobs(kp) if z_vals.is_cuda else None
        out = fused_render_fwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, white_bkgd, blobs,
                               keep_raw=True)
        ctx.save_for_backward(rays_o, rays_d, viewdirs, z_vals, noise, out.raw, *leaves)
        ctx.blobs, ctx.white_bkgd = blobs, white_bkgd
        return out.rgb, out.disp, out.acc, out.w

    @staticmethod
    def backward(ctx, g_rgb, g_disp, g_acc, g_w):
        ro, rd, vd, z, noise, raw, *leaves = ctx.saved_tensors
        kp = dict(zip(KP_NAMES, leaves))
        R, S = z.shape
        grads = fused_mlp.sum_grads(
            fused_render_bwd(kp, *_rays_slice((ro, rd, vd, z, noise), a, b), raw[:, a:b],
                             *_rays_slice((g_rgb, g_disp, g_acc, g_w), a, b), ctx.white_bkgd,
                             ctx.blobs)
            for a, b in fused_mlp.bwd_slices(R, S * fused_mlp.bwd_point_bytes(kp, S),
                                             fused_mlp.SLICE_COLS))
        ctx.blobs = None
        return (None,) * 6 + tuple(grads[n].to(kp[n].dtype) for n in KP_NAMES)


def fused_render_level(
    mlp: NeRFMLP,
    cfg: MLPConfig,
    pe_pts: PosEncConfig,
    pe_views: PosEncConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    noise: Optional[torch.Tensor],
    white_bkgd: bool,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> RayOutputs:
    """One coarse/fine level, rays -> composited maps (nerf_tpu's
    fused_render_level). ``depth`` is Σ w·z, taken outside the kernel as
    there. Under autograd (grad enabled and a parameter that requires grad)
    the weights are packed anew with their graph and the call
    differentiates through K6; otherwise the packing kept on the module
    serves the forward alone."""
    if not supports(cfg, pe_pts, pe_views, z_vals.shape[-1]):
        raise ValueError("fused_render_level: unsupported MLP / posenc / sample count")
    ro, rd, vd, z = (t.detach() for t in (rays_o, rays_d, viewdirs, z_vals))
    nz = None if noise is None else noise.detach()
    if torch.is_grad_enabled() and any(p.requires_grad for p in mlp.parameters()):
        kp = fused_mlp.pack_params(mlp, pe_pts, pe_views, compute_dtype)
        rgb, disp, acc, w = _FusedRender.apply(ro, rd, vd, z, nz, white_bkgd,
                                               *(kp[n] for n in KP_NAMES))
    else:
        kp, blobs = fused_mlp.packed_params(mlp, pe_pts, pe_views, compute_dtype)
        rgb, disp, acc, w, _ = fused_render_fwd(kp, ro, rd, vd, z, nz, white_bkgd, blobs)
    depth = torch.sum(w * z, -1)
    return RayOutputs(rgb=rgb, disp=disp, acc=acc, weights=w, depth=depth)


# ------------------------------------------------- stacked (multi-scene) K5/K6
#
# Multi-scene training with --fused_render: S nets of one shape stacked
# ([S, ...] leaves), the rays of scene s at [s] of [S, R, ...] inputs, and
# each level one K5 launch over every scene's ray groups (each tile on its
# own scene's weights) and one K6: its compositing pass over all S*R rays
# (it holds no weights), then the stacked K4's phases (nerf_tpu vmaps its
# step, and with it the Pallas calls, over the scene axis:
# parallel/multi_scene.py:44-64). Each scene's rays are padded to
# fused_mlp._pad_rays, whole ray groups and whole 64-ray columns, so that
# no group, tile or column spans two scenes; padded rays carry a zero
# cotangent.


def _stack_maps(per) -> Maps:
    return Maps(*(None if per[0][i] is None else torch.stack([m[i] for m in per],
                                                             0 if i < 4 else 1)
                  for i in range(5)))


def fused_render_stacked_reference(kp, rays_o, rays_d, viewdirs, z_vals, noise,
                                   white_bkgd: bool) -> Maps:
    """Plain PyTorch version of the stacked K5: K5's plain version applied
    scene by scene, the maps [S, R, ...] and raw planes [4, S, R, N]."""
    return _stack_maps([fused_render_reference(
        fused_mlp._scene(kp, s), rays_o[s], rays_d[s], viewdirs[s], z_vals[s],
        None if noise is None else noise[s], white_bkgd) for s in range(z_vals.shape[0])])


def fused_render_stacked_bwd_reference(kp, rays_o, rays_d, viewdirs, z_vals, noise, raw, g_rgb,
                                       g_disp, g_acc, g_w, white_bkgd: bool
                                       ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the stacked K6: K6's plain version applied
    scene by scene, grads with kp's stacked shapes."""
    per = [fused_render_bwd_reference(
        fused_mlp._scene(kp, s), rays_o[s], rays_d[s], viewdirs[s], z_vals[s],
        None if noise is None else noise[s], raw[:, s].contiguous(), g_rgb[s], g_disp[s],
        g_acc[s], g_w[s], white_bkgd) for s in range(z_vals.shape[0])]
    return {k: torch.stack([g[k] for g in per]) for k in per[0]}


def _check_stacked(kp, rays_o, rays_d, viewdirs, z_vals, noise, **per_ray) -> None:
    fused_mlp._check_stacked(kp, rays_o, rays_d, viewdirs, z_vals)
    S, R, N = z_vals.shape
    flat = {k: None if t is None else t.flatten(1, 2) if k == "raw" else t.flatten(0, 1)
            for k, t in per_ray.items()}
    _check(*(t.flatten(0, 1) for t in (rays_o, rays_d, viewdirs, z_vals)),
           None if noise is None else noise.flatten(0, 1), **flat)
    shapes = {"raw": (4, S, R, N), "g_rgb": (S, R, 3), "g_disp": (S, R), "g_acc": (S, R),
              "g_w": (S, R, N)}
    for name, t in dict(per_ray, noise=noise).items():
        want = (S, R, N) if name == "noise" else shapes[name]
        if t is not None and t.shape != want:
            raise ValueError(f"{name}: expected {want}, got {tuple(t.shape)}")


def _launch_composite(raw_planes, rays_d, z_vals, noise, white_bkgd: bool, out) -> None:
    """K5w's compositing launch (``nerf_fused_render_composite``, a warp per
    ray on K5's compositing) of raw planes [4, R, S] into the maps ``out``."""
    R, S = z_vals.shape
    if R * S == 0:
        return
    lib = _build.load("fused_render")
    rd, z = rays_d.contiguous(), z_vals.contiguous()
    nz = None if noise is None else noise.contiguous()
    with torch.cuda.device(z.device):
        err = lib.nerf_fused_render_composite(
            rd.data_ptr(), z.data_ptr(), _ptr(nz), raw_planes.data_ptr(), R, S, int(white_bkgd),
            *(t.data_ptr() for t in out[:4]), torch.cuda.current_stream(z.device).cuda_stream)
    fused_mlp._raise_on(lib, err, "fused_render_composite")


def composite_maps_reference(raw_planes, rays_d, z_vals, noise, white_bkgd: bool) -> Maps:
    """The maps of raw planes [4, R, S], K5w's compositing's plain version
    (raw not kept)."""
    cmp = _composite(raw_planes, rays_d, z_vals, noise, white_bkgd)
    return Maps(cmp["rgb_map"], cmp["disp"], cmp["acc"], cmp["w"], None)


def launch_composite_maps(raw_planes, rays_d, z_vals, noise, white_bkgd: bool) -> Maps:
    """The maps of raw planes [4, R, S] on the card: one launch of K5w's
    compositing (``nerf_fused_render_composite``; raw not kept)."""
    R, S = z_vals.shape
    f32 = dict(dtype=torch.float32, device=z_vals.device)
    out = Maps(torch.empty(R, 3, **f32), torch.empty(R, **f32), torch.empty(R, **f32),
               torch.empty(R, S, **f32), None)
    _launch_composite(raw_planes, rays_d, z_vals, noise, white_bkgd, out)
    return out


def render_wide_stacked(ops, kp, rays_o, rays_d, viewdirs, z_vals, noise, white_bkgd: bool,
                        blobs=None, keep_raw: bool = False) -> Maps:
    """K5ws's launches on ``ops`` (fused_mlp_wide's Ops, or PlainOps, whose
    compositing is the plain version): each scene's rays zero-padded to
    ``fused_mlp_wide.cols`` of them, K1ws's launches into raw planes [4, S,
    V, N], then one compositing over every scene's S V rays; the maps [S, R,
    ...] (and raw planes [4, S, R, N] with ``keep_raw``)."""
    S, R, N = z_vals.shape
    V = fused_mlp_wide.cols(R)
    ro, rd, vd, z = fused_mlp._padded((rays_o, rays_d, viewdirs, z_vals), V)
    nz = None if noise is None else fused_mlp._padded((noise,), V)[0]
    raw = fused_mlp_wide.rays_planes_stacked_padded(ops, kp, ro, rd, vd, z, blobs)
    flat = lambda t: None if t is None else t.flatten(0, 1)  # noqa: E731
    maps = ops.composite(raw.view(4, S * V, N), flat(rd), flat(z), flat(nz), white_bkgd)
    return Maps(*(t.unflatten(0, (S, V))[:, :R] for t in maps[:4]),
                raw[:, :, :R] if keep_raw else None)


def render_wide_stacked_bwd(ops, kp, rays_o, rays_d, viewdirs, z_vals, noise, raw, g_rgb, g_disp,
                            g_acc, g_w, white_bkgd: bool, blobs=None) -> Dict[str, torch.Tensor]:
    """K6ws's launches on ``ops``: each scene's rays zero-padded to
    ``fused_mlp_wide.cols`` of them (zero cotangents), K6's compositing pass
    once over every scene's rays, then K4ws's launches; the f32 grads of the
    stacked packed leaves."""
    S, R, N = z_vals.shape
    V = fused_mlp_wide.cols(R)
    pad = lambda t, dim=1: None if t is None else fused_mlp._padded((t,), V, dim)[0]  # noqa: E731
    ro, rd, vd, z = (pad(t) for t in (rays_o, rays_d, viewdirs, z_vals))
    nz, gr, gd, ga, gw = (pad(t) for t in (noise, g_rgb, g_disp, g_acc, g_w))
    flat = lambda t: None if t is None else t.flatten(0, 1)  # noqa: E731
    g_planes = ops.composite_bwd(pad(raw, 2).flatten(1, 2), flat(rd), flat(z), flat(nz),
                                 flat(gr), flat(gd), flat(ga), flat(gw), white_bkgd)
    return fused_mlp_wide.rays_planes_stacked_bwd_padded(ops, kp, ro, rd, vd, z,
                                                         g_planes.view(4, S, V, N), blobs)


def fused_render_wide_stacked_fwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, white_bkgd, blobs,
                                  keep_raw) -> Maps:
    """K5ws on CUDA tensors, ``fused_render_stacked_fwd``'s arguments:
    ``render_wide_stacked``'s launches (``launches`` counts the calls)."""
    out = render_wide_stacked(fused_mlp_wide._ops(kp, z_vals), kp, rays_o, rays_d, viewdirs,
                              z_vals, noise, white_bkgd, blobs, keep_raw)
    fused_render_wide_stacked_fwd.launches += 1
    return out


fused_render_wide_stacked_fwd.launches = 0


def fused_render_wide_stacked_bwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, raw, g_rgb, g_disp,
                                  g_acc, g_w, white_bkgd, blobs=None) -> Dict[str, torch.Tensor]:
    """K6ws on CUDA tensors, ``fused_render_stacked_bwd``'s arguments:
    ``render_wide_stacked_bwd``'s launches, its compositing pass counted by
    ``composite_bwd.launches`` (``launches`` counts the calls)."""
    grads = render_wide_stacked_bwd(fused_mlp_wide._ops(kp, z_vals), kp, rays_o, rays_d, viewdirs,
                                    z_vals, noise, raw, g_rgb, g_disp, g_acc, g_w, white_bkgd,
                                    blobs)
    fused_render_wide_stacked_bwd.launches += 1
    return grads


fused_render_wide_stacked_bwd.launches = 0


def fused_render_stacked_fwd(kp: Dict[str, torch.Tensor], rays_o, rays_d, viewdirs, z_vals,
                             noise: Optional[torch.Tensor], white_bkgd: bool,
                             blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                             keep_raw: bool = False) -> Maps:
    """The maps of one level of S scenes from stacked packed params ([S, ...]
    leaves), rays [S, R, 3], depths and sigma noise [S, R, N] (None: none):
    rgb [S, R, 3], disp, acc [S, R], w [S, R, N], and raw planes
    [4, S, R, N] with ``keep_raw``; scene s's rays through scene s's net.
    CUDA tensors launch the stacked K5 once for every scene (``launches``
    counts one a launch, whatever S is), each scene's rays zero-padded to
    ``fused_mlp._pad_rays``; CPU tensors take the plain version. ``blobs``
    is ``fused_mlp.kernel_blobs(kp)`` where the caller keeps it."""
    _check_stacked(kp, rays_o, rays_d, viewdirs, z_vals, noise)
    if z_vals.device.type == "cpu":
        out = fused_render_stacked_reference(kp, rays_o, rays_d, viewdirs, z_vals, noise,
                                             white_bkgd)
        return out if keep_raw else out._replace(raw=None)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {z_vals.device}")
    if fused_mlp.is_wide(kp):
        return fused_render_wide_stacked_fwd(kp, rays_o, rays_d, viewdirs, z_vals, noise,
                                             white_bkgd, blobs, keep_raw)
    lib = _build.load("fused_render")
    dtype, W, Fp, Fv = fused_mlp._kernel_config(kp, z_vals)
    dev = z_vals.device
    S, R, N = z_vals.shape
    R_pad = fused_mlp._pad_rays(R, N)
    ro, rd, vd, z = fused_mlp._padded((rays_o, rays_d, viewdirs, z_vals), R_pad)
    nz = None if noise is None else fused_mlp._padded((noise,), R_pad)[0]
    f32 = dict(dtype=torch.float32, device=dev)
    out = Maps(torch.empty(S, R_pad, 3, **f32), torch.empty(S, R_pad, **f32),
               torch.empty(S, R_pad, **f32), torch.empty(S, R_pad, N, **f32),
               torch.empty(4, S, R_pad, N, **f32) if keep_raw else None)
    wblob, bblob = fused_mlp.kernel_blobs(kp) if blobs is None else blobs
    slab = None  # the bf16 kernel's scratch where raw planes are not kept
    if dtype == torch.bfloat16 and not keep_raw:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slab = torch.empty(slab_floats(R_pad, N, sms, S), **f32)
    with torch.cuda.device(dev):
        err = lib.nerf_fused_render_fwd_stacked(
            int(dtype == torch.bfloat16), W, ro.data_ptr(), rd.data_ptr(), vd.data_ptr(),
            z.data_ptr(), _ptr(nz), S, R_pad, N, Fp, Fv, int(white_bkgd), wblob.data_ptr(),
            bblob.data_ptr(), *(_ptr(t) for t in out), _ptr(slab),
            0 if slab is None else slab.numel(), torch.cuda.current_stream(dev).cuda_stream,
        )
    fused_mlp._raise_on(lib, err, "fused_render_fwd_stacked")
    fused_render_stacked_fwd.launches += 1
    return Maps(*(t[:, :R] for t in out[:4]), None if out.raw is None else out.raw[:, :, :R])


fused_render_stacked_fwd.launches = 0


def fused_render_stacked_bwd(kp: Dict[str, torch.Tensor], rays_o, rays_d, viewdirs, z_vals,
                             noise: Optional[torch.Tensor], raw, g_rgb, g_disp, g_acc, g_w,
                             white_bkgd: bool,
                             blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                             ) -> Dict[str, torch.Tensor]:
    """float32 grads of the stacked packed leaves (kp's [S, ...] shapes) from
    the cotangents of ``fused_render_stacked_fwd``'s maps (g_rgb [S, R, 3],
    g_disp, g_acc [S, R], g_w [S, R, N]), given its raw planes [4, S, R, N]:
    each scene's the grads of its own net. CUDA tensors launch the stacked
    K6 (``launches`` counts one): K6's compositing pass once over every
    scene's padded rays (``composite_bwd.launches`` counts it), then the
    stacked K4's phases; CPU tensors take the plain version."""
    _check_stacked(kp, rays_o, rays_d, viewdirs, z_vals, noise, raw=raw, g_rgb=g_rgb,
                   g_disp=g_disp, g_acc=g_acc, g_w=g_w)
    if z_vals.device.type == "cpu":
        return fused_render_stacked_bwd_reference(kp, rays_o, rays_d, viewdirs, z_vals, noise,
                                                  raw, g_rgb, g_disp, g_acc, g_w, white_bkgd)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {z_vals.device}")
    if fused_mlp.is_wide(kp):
        return fused_render_wide_stacked_bwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, raw,
                                             g_rgb, g_disp, g_acc, g_w, white_bkgd, blobs)
    fused_mlp._kernel_config(kp, z_vals)
    S, R, N = z_vals.shape
    R_pad = fused_mlp._pad_rays(R, N)
    pad = lambda t, dim=1: None if t is None else fused_mlp._padded((t,), R_pad, dim)[0]  # noqa: E731
    ro, rd, vd, z = (pad(t) for t in (rays_o, rays_d, viewdirs, z_vals))
    # padded rays: zero cotangents, so a zero cotangent of their raw
    nz, gr, gd, ga, gw = (pad(t) for t in (noise, g_rgb, g_disp, g_acc, g_w))
    rawp = pad(raw, 2)
    flat = lambda t: None if t is None else t.flatten(0, 1)  # noqa: E731
    g_planes = _launch_composite_bwd(rawp.flatten(1, 2), flat(rd), flat(z), flat(nz), flat(gr),
                                     flat(gd), flat(ga), flat(gw), white_bkgd)
    grads = fused_mlp._launch_stacked_bwd(kp, ro, rd, vd, z, g_planes.view(4, S, R_pad, N), blobs)
    fused_render_stacked_bwd.launches += 1
    return grads


fused_render_stacked_bwd.launches = 0


class _FusedRenderStacked(torch.autograd.Function):
    """The stacked K5 forward, the stacked K6 backward over stacked packed
    leaves (KP_NAMES order), as ``_FusedRender`` for one net."""

    @staticmethod
    def forward(ctx, rays_o, rays_d, viewdirs, z_vals, noise, white_bkgd, *leaves):
        kp = dict(zip(KP_NAMES, leaves))
        blobs = fused_mlp.kernel_blobs(kp) if z_vals.is_cuda else None
        out = fused_render_stacked_fwd(kp, rays_o, rays_d, viewdirs, z_vals, noise, white_bkgd,
                                       blobs, keep_raw=True)
        ctx.save_for_backward(rays_o, rays_d, viewdirs, z_vals, noise, out.raw, *leaves)
        ctx.blobs, ctx.white_bkgd = blobs, white_bkgd
        return out.rgb, out.disp, out.acc, out.w

    @staticmethod
    def backward(ctx, g_rgb, g_disp, g_acc, g_w):
        ro, rd, vd, z, noise, raw, *leaves = ctx.saved_tensors
        kp = dict(zip(KP_NAMES, leaves))
        S, R, N = z.shape
        grads = fused_mlp.sum_grads(
            fused_render_stacked_bwd(
                kp, *_rays_slice((ro, rd, vd, z, noise), a, b, 1), raw[:, :, a:b],
                *(t.contiguous() for t in _rays_slice((g_rgb, g_disp, g_acc, g_w), a, b, 1)),
                ctx.white_bkgd, ctx.blobs)
            for a, b in fused_mlp.bwd_slices(R, S * N * fused_mlp.bwd_point_bytes(kp, N),
                                             fused_mlp.SLICE_COLS))
        ctx.blobs = None
        return (None,) * 6 + tuple(grads[n].to(kp[n].dtype) for n in KP_NAMES)


def fused_render_level_stacked(
    mlp,
    cfg: MLPConfig,
    pe_pts: PosEncConfig,
    pe_views: PosEncConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    noise: Optional[torch.Tensor],
    white_bkgd: bool,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> RayOutputs:
    """``fused_render_level`` for a stacked net (render/network.py's
    StackedNeRFMLP): rays [S, R, 3], depths and noise [S, R, N] in, the maps
    of every scene out ([S, R, ...]), scene s's through scene s's net.
    Under autograd the weights are packed anew with their graph and the
    call differentiates through the stacked K6; otherwise the packing kept
    on the module serves the forward alone."""
    if not supports_stacked(cfg, pe_pts, pe_views, z_vals.shape[-1]):
        raise ValueError("fused_render_level_stacked: unsupported MLP / posenc / sample count")
    ro, rd, vd, z = (t.detach() for t in (rays_o, rays_d, viewdirs, z_vals))
    nz = None if noise is None else noise.detach()
    if torch.is_grad_enabled() and any(p.requires_grad for p in mlp.parameters()):
        kp = fused_mlp.pack_params(mlp, pe_pts, pe_views, compute_dtype)
        _check_stacked(kp, ro, rd, vd, z, nz)
        rgb, disp, acc, w = _FusedRenderStacked.apply(ro, rd, vd, z, nz, white_bkgd,
                                                      *(kp[n] for n in KP_NAMES))
    else:
        kp, blobs = fused_mlp.packed_params(mlp, pe_pts, pe_views, compute_dtype)
        rgb, disp, acc, w, _ = fused_render_stacked_fwd(kp, ro, rd, vd, z, nz, white_bkgd, blobs)
    depth = torch.sum(w * z, -1)
    return RayOutputs(rgb=rgb, disp=disp, acc=acc, weights=w, depth=depth)
