"""The coarse/fine volume renderer.

Counterpart of nerf_tpu/render/renderer.py (ref render_rays
run_nerf.py:308-418; render / batchify_rays run_nerf.py:54-134):

- hyperparameters ride in a frozen ``RenderSettings``;
- randomness comes from one ``torch.Generator``, drawn in the order jitter,
  coarse noise, importance u, fine noise; parity tests inject exact arrays
  through ``overrides`` (t_rand / noise0 / u / noise1);
- each level takes nerf_tpu's first branch that applies: the fused render
  (``model.fused_render``, viewdirs, no retraw, S % 8 == 0: K5/K6 from rays
  to maps), the raygen fused MLP (``model.fused``, S % 8 == 0: K1/K4; its
  planes composited in bf16 by nerf_tpu's matmul scan, in f32 by the exact
  cumprod), or the points-in query (K2/K3 when fused, else plain PyTorch);
- stacked nets (``StackedNeRFMLP``, multi-scene training) take the rays of
  their S scenes one scene after another, [S*R]: sampling and compositing
  run once over all of them, and each level takes the branch one net would
  take, stacked (nerf_tpu vmaps the whole step): the stacked K5/K6, K1/K4
  or K2/K3, one launch for every scene, or the stacked plain MLP;
- full frames are rendered in chunks by a Python loop; with a mesh (data
  parallelism, parallel/mesh.py) each rank renders its rows of the frame
  and the ranks gather the maps;
- importance samples are detached (ref run_nerf.py:394), and rays and
  sample depths never carry gradients into the network.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.experimental import fused_render
from nerf_tpu_torch.geom.rays import get_rays, ndc_rays
from nerf_tpu_torch.ops import fused_mlp
from nerf_tpu_torch.ops.compositing import raw2outputs, raw2outputs_planes, sigma_noise
from nerf_tpu_torch.ops.sampling import sample_pdf, stratified_z_vals
from nerf_tpu_torch.render.network import (
    NeRFModel, StackedNeRFMLP, query_raw, query_raw_stacked,
)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Rendering hyperparameters (ref render_kwargs, run_nerf.py:237-247)."""

    n_samples: int = 64
    n_importance: int = 0
    perturb: bool = True
    use_viewdirs: bool = True
    white_bkgd: bool = False
    raw_noise_std: float = 0.0
    lindisp: bool = False
    ndc: bool = False
    retraw: bool = False

    def eval_mode(self) -> "RenderSettings":
        """Test-time variant: no jitter, no sigma noise (ref run_nerf.py:255-257)."""
        return dataclasses.replace(self, perturb=False, raw_noise_std=0.0, retraw=False)


def render_rays(
    nets: Mapping[str, torch.nn.Module],
    model: NeRFModel,
    rs: RenderSettings,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
    near: torch.Tensor,
    far: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    overrides: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Volume-render a batch of rays (ref render_rays, run_nerf.py:308-418).

    Args:
        nets: {"coarse": NeRFMLP, "fine": NeRFMLP (optional)}, a dict or
            an ``nn.ModuleDict``.
        rays_o, rays_d: [R, 3] (rays_d NOT normalized).
        viewdirs: [R, 3] unit directions or None.
        near, far: [R] per-ray bounds.
        generator: random source, needed when rs.perturb or
            rs.raw_noise_std > 0 and no override replaces the draw.
        overrides: {t_rand, noise0, u, noise1} replacing the random draws.

    Returns rgb_map/disp_map/acc_map (+ rgb0/disp0/acc0/z_std with a fine
    level, + raw with rs.retraw).
    """
    overrides = overrides or {}
    z_vals = stratified_z_vals(
        near,
        far,
        rs.n_samples,
        lindisp=rs.lindisp,
        perturb=rs.perturb,
        generator=generator,
        t_rand=overrides.get("t_rand"),
    )

    def run_level(level: str, z: torch.Tensor, noise_override):
        mlp = nets[level] if level in nets else nets["coarse"]
        mlp_cfg = model.mlp_config(level)
        S = z.shape[-1]
        # stacked nets: the same branches, each op's stacked form on the
        # rays as [scenes, R, ...] (scene s's R rays through scene s's net)
        stacked = isinstance(mlp, StackedNeRFMLP)

        def per_scene(t):
            return t.detach().reshape(mlp.n_scenes, -1, *t.shape[1:])

        if (
            model.fused_render
            and viewdirs is not None
            and not rs.retraw
            and fused_render.supports(mlp_cfg, model.pe_pts, model.pe_views, S)
        ):
            # rays -> maps in one kernel per level (K5, K6 backward); raw
            # never exists outside it. The noise is the draw raw2outputs_planes
            # would make at this point of the generator's stream.
            noise = noise_override
            if noise is None:
                noise = sigma_noise(z, rs.raw_noise_std, generator)
            if stacked:
                out = fused_render.fused_render_level_stacked(
                    mlp, mlp_cfg, model.pe_pts, model.pe_views,
                    *(per_scene(t) for t in (rays_o, rays_d, viewdirs, z)),
                    None if noise is None else per_scene(noise), rs.white_bkgd,
                    compute_dtype=model.torch_compute_dtype,
                )
                return None, dataclasses.replace(
                    out, **{k: t.flatten(0, 1) for k, t in vars(out).items()})
            out = fused_render.fused_render_level(
                mlp, mlp_cfg, model.pe_pts, model.pe_views, rays_o, rays_d, viewdirs, z,
                noise, rs.white_bkgd, compute_dtype=model.torch_compute_dtype,
            )
            return None, out
        if (
            model.fused
            and viewdirs is not None
            and fused_mlp.supports(mlp_cfg, model.pe_pts, model.pe_views)
            and S % 8 == 0
            and S > 1
        ):
            # raygen + planes mode: the points and the per-point raw never
            # exist outside the kernel
            if stacked:
                raw4 = fused_mlp.fused_query_rays_planes_stacked(
                    mlp, mlp_cfg, model.pe_pts, model.pe_views,
                    *(per_scene(t) for t in (rays_o, rays_d, viewdirs, z)),
                    compute_dtype=model.torch_compute_dtype,
                ).flatten(1, 2)
            else:
                raw4 = fused_mlp.fused_query_rays_planes(
                    mlp, mlp_cfg, model.pe_pts, model.pe_views,
                    rays_o.detach(), rays_d.detach(), viewdirs.detach(), z.detach(),
                    compute_dtype=model.torch_compute_dtype,
                )
            # nerf_tpu's matmul scan in bf16 (renderer.py:159), the exact
            # cumprod in f32
            out = raw2outputs_planes(
                raw4, z, rays_d,
                raw_noise_std=rs.raw_noise_std, white_bkgd=rs.white_bkgd,
                generator=generator, noise=noise_override,
                matmul_scan=model.torch_compute_dtype == torch.bfloat16,
            )
            raw = raw4.movedim(0, -1) if rs.retraw else None
            return raw, out

        # points-in mode (K2/K3 when fused): rays and depths carry no grad
        # into the network, so the backward skips its input-grad branch
        pts = (rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]).detach()
        vd = None if viewdirs is None else viewdirs.detach()
        if stacked:
            raw = query_raw_stacked(mlp, model, per_scene(pts),
                                    None if vd is None else per_scene(vd)).flatten(0, 1)
        else:
            raw = query_raw(mlp, model, pts, vd, input_grads=False)
        out = raw2outputs(
            raw, z, rays_d,
            raw_noise_std=rs.raw_noise_std, white_bkgd=rs.white_bkgd,
            generator=generator, noise=noise_override,
        )
        return raw, out

    raw, coarse = run_level("coarse", z_vals, overrides.get("noise0"))
    ret = {"rgb_map": coarse.rgb, "disp_map": coarse.disp, "acc_map": coarse.acc}

    if rs.n_importance > 0:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(
            z_mid,
            coarse.weights[..., 1:-1],
            rs.n_importance,
            det=not rs.perturb,
            generator=generator,
            u=overrides.get("u"),
        ).detach()  # ref detach run_nerf.py:394
        z_all = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
        raw, fine = run_level("fine", z_all, overrides.get("noise1"))
        ret = {
            "rgb_map": fine.rgb,
            "disp_map": fine.disp,
            "acc_map": fine.acc,
            "rgb0": coarse.rgb,
            "disp0": coarse.disp,
            "acc0": coarse.acc,
            "z_std": torch.std(z_samples, dim=-1, correction=0),  # jnp.std: population
        }
    if rs.retraw:
        ret["raw"] = raw
    return ret


def prepare_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    rs: RenderSettings,
    H: int,
    W: int,
    focal: float,
    near: float,
    far: float,
    viewdirs_from: Optional[torch.Tensor] = None,
):
    """Viewdirs + NDC + flattening (ref render(), run_nerf.py:102-123).

    ``viewdirs_from`` serves the c2w_staticcam visualization
    (run_nerf.py:105-107): the directions for shading come from another
    camera than the rendered rays."""
    viewdirs = None
    if rs.use_viewdirs:
        vd = viewdirs_from if viewdirs_from is not None else rays_d
        viewdirs = vd / torch.linalg.norm(vd, dim=-1, keepdim=True)
        viewdirs = viewdirs.reshape(-1, 3)
    if rs.ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    near_v = torch.full(rays_o.shape[:1], near, dtype=rays_o.dtype, device=rays_o.device)
    far_v = torch.full(rays_o.shape[:1], far, dtype=rays_o.dtype, device=rays_o.device)
    return rays_o, rays_d, viewdirs, near_v, far_v


def render_image(
    nets: Mapping[str, torch.nn.Module],
    model: NeRFModel,
    rs: RenderSettings,
    H: int,
    W: int,
    K,
    c2w: torch.Tensor,
    near: float,
    far: float,
    chunk: int = 1024 * 32,
    generator: Optional[torch.Generator] = None,
    c2w_staticcam: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Render a full H×W frame on ``c2w``'s device, in ray chunks (ref
    render + batchify_rays). Chunking changes memory, not results. With
    ``c2w_staticcam`` the frame shades with c2w's directions and renders
    c2w_staticcam's rays (ref run_nerf.py:105-107)."""
    rays_o, rays_d = get_rays(H, W, K, c2w)
    viewdirs_from = None
    if c2w_staticcam is not None:
        viewdirs_from = rays_d
        rays_o, rays_d = get_rays(H, W, K, c2w_staticcam)
    focal = float(np.asarray(K)[0, 0])
    rays_o, rays_d, viewdirs, near_v, far_v = prepare_rays(
        rays_o, rays_d, rs, H, W, focal, near, far, viewdirs_from
    )
    out = render_rays_chunked(
        nets, model, rs, rays_o, rays_d, viewdirs, near_v, far_v,
        chunk=chunk, generator=generator,
    )
    return {k: v.reshape(H, W, *v.shape[1:]) for k, v in out.items()}


def render_rays_chunked(
    nets: Mapping[str, torch.nn.Module],
    model: NeRFModel,
    rs: RenderSettings,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
    near_v: torch.Tensor,
    far_v: torch.Tensor,
    chunk: int = 1024 * 32,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Render a flat ray batch chunk by chunk; returns flat [N, ...] outputs.
    The last chunk is simply shorter (no padding)."""
    outs = []
    for s in range(0, rays_o.shape[0], chunk):
        sl = slice(s, s + chunk)
        vd = None if viewdirs is None else viewdirs[sl]
        outs.append(
            render_rays(
                nets, model, rs, rays_o[sl], rays_d[sl], vd, near_v[sl], far_v[sl],
                generator=generator,
            )
        )
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


def make_frame_renderer(
    model: NeRFModel,
    rs: RenderSettings,
    H: int,
    W: int,
    K,
    near: float,
    far: float,
    chunk: int = 1024 * 32,
    device: DeviceLike = None,
    mesh=None,
):
    """A (nets, c2w) -> frame function for eval/video paths, rendering on
    ``device`` (the card unless told otherwise) without autograd.

    With a ``mesh`` (parallel/mesh.py; nerf_tpu's ``shard_body``,
    renderer.py:337-430) every rank of it must call the function: the
    frame's H*W rays are padded to a multiple of the ranks (the last ray
    repeated), each data index renders its rows in chunks (the ranks of a
    model group the same rows, through their model-parallel nets), and one
    ``all_gather`` over the data group gives every rank the whole frame. It
    is for the deterministic eval settings (``rs.eval_mode()``): with jitter
    or noise the ranks' draws would not be the one-process frame's, so
    those raise."""
    dev = resolve_device(device)
    K = np.asarray(K, np.float32)

    if mesh is None:
        @torch.no_grad()
        def render_frame(nets, c2w):
            c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
            return render_image(nets, model, rs, H, W, K, c2w, near, far, chunk=chunk)

        return render_frame

    if rs.perturb or rs.raw_noise_std > 0.0:
        raise ValueError("the mesh-sharded frame renderer needs deterministic settings "
                         "(rs.eval_mode()): got perturb or raw_noise_std > 0")
    n = H * W
    per = -(-n // mesh.size)
    rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    focal = float(K[0, 0])

    @torch.no_grad()
    def render_sharded(nets, c2w):
        c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
        rays_o, rays_d = get_rays(H, W, K, c2w)
        rays = prepare_rays(rays_o, rays_d, rs, H, W, focal, near, far)
        pad = per * mesh.size - n
        ro, rd, vd, nv, fv = (
            None if x is None else torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])[rows]
            for x in rays
        )
        out = render_rays_chunked(nets, model, rs, ro, rd, vd, nv, fv, chunk=min(chunk, per))
        keys = sorted(out)
        flat = torch.cat([out[k].reshape(per, -1) for k in keys], 1)
        parts = [torch.empty_like(flat) for _ in range(mesh.size)]
        dist.all_gather(parts, flat, group=mesh.data_group)
        full = torch.cat(parts)[:n]
        frame, col = {}, 0
        for k in keys:
            width = out[k][0].numel()
            frame[k] = full[:, col : col + width].to(out[k].dtype).reshape(H, W, *out[k].shape[1:])
            col += width
        return frame

    return render_sharded
