"""The experiment loop: model -> optimization loop, and the eval renders.

Counterpart of nerf_tpu/train/loop.py (ref ``train()``, run_nerf.py:534-872,
and ``render_path``, run_nerf.py:137-175), for one device. ``train`` runs
the render-only short-circuit or the step loop with the i_print cadence;
what it does not do yet raises (see ``_check_supported``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nerf_tpu_torch.config import NeRFConfig, dump_config
from nerf_tpu_torch.data.rays_dataset import make_sampler
from nerf_tpu_torch.data.scene import Scene
from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.factory import init_nets, make_model
from nerf_tpu_torch.ops.fused_mlp import flops_per_point
from nerf_tpu_torch.render.renderer import RenderSettings, make_frame_renderer
from nerf_tpu_torch.train.step import TrainState, init_train_state, make_train_step
from nerf_tpu_torch.utils.io import save_png
from nerf_tpu_torch.utils.metrics import psnr_np
from nerf_tpu_torch.utils.profiler import StepTimer, device_peak_flops


def render_settings_from_config(cfg: NeRFConfig) -> RenderSettings:
    return RenderSettings(
        n_samples=cfg.N_samples,
        n_importance=cfg.N_importance,
        perturb=cfg.perturb > 0.0,
        use_viewdirs=cfg.use_viewdirs,
        white_bkgd=cfg.white_bkgd,
        raw_noise_std=cfg.raw_noise_std,
        lindisp=cfg.lindisp,
        ndc=cfg.ndc,
    )


def render_path(
    nets,
    model,
    rs: RenderSettings,
    scene: Scene,
    poses: np.ndarray,
    chunk: int,
    render_factor: int = 0,
    savedir: Optional[str] = None,
    gt_imgs: Optional[np.ndarray] = None,
    render_frame=None,
    device: DeviceLike = None,
):
    """Render a pose path in eval mode; returns (rgbs, disps) as numpy
    [M, H, W, ...]. ``render_factor`` downsamples for previews;
    ``render_frame`` (a make_frame_renderer result) may be reused across
    calls. Writes ``savedir/NNN.png`` per frame when given, and prints the
    mean PSNR against ``gt_imgs`` when given."""
    H, W, focal = scene.H, scene.W, scene.focal
    if render_factor != 0:
        # a passed-in render_frame was built at full H/W: rebuild instead
        render_frame = None
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)

    rs_eval = rs.eval_mode()
    near, far = (0.0, 1.0) if rs.ndc else (scene.near, scene.far)
    if render_frame is None:
        render_frame = make_frame_renderer(
            model, rs_eval, H, W, K, near, far, chunk=chunk, device=device
        )

    rgbs, disps, psnrs = [], [], []

    def drain(i, out):
        # device->host fetch (the only sync) + host-side PNG/PSNR work,
        # overlapped with the next frame's device work (already enqueued)
        rgb = out["rgb_map"].cpu().numpy()
        rgbs.append(rgb)
        disps.append(out["disp_map"].cpu().numpy())
        if gt_imgs is not None and render_factor == 0:
            psnrs.append(psnr_np(rgb, np.asarray(gt_imgs[i])))
        if savedir is not None:
            save_png(os.path.join(savedir, f"{i:03d}.png"), rgb)

    # depth-2 pipeline: enqueue frame i+1 before fetching frame i
    pending = None
    for i, c2w in enumerate(poses):
        out = render_frame(nets, np.asarray(c2w)[:3, :4])
        if pending is not None:
            drain(*pending)
        pending = (i, out)
    if pending is not None:
        drain(*pending)
    if psnrs:
        print(f"[EVAL] mean PSNR over {len(psnrs)} views: {np.mean(psnrs):.3f}")
    return np.stack(rgbs, 0), np.stack(disps, 0)


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: list  # [(step, loss, psnr)] at each i_print


def _check_supported(cfg: NeRFConfig, dev: torch.device) -> None:
    """Raise on what nerf_tpu's train() does and this one does not yet."""
    missing = []
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if cfg.data_axis > 1 or (cfg.data_axis == 0 and n_cards > 1):
        missing.append("data parallelism over several devices (ROADMAP A.8); set data_axis=1")
    if cfg.ft_path not in (None, "None"):
        missing.append("ft_path / resuming from a checkpoint (ROADMAP A.5)")
    for name in ("i_img", "i_weights", "i_testset", "i_video"):
        every = getattr(cfg, name)
        if 0 < every <= cfg.n_iters:
            missing.append(f"{name}={every} (eval renders and checkpoints, ROADMAP A.3/A.5); "
                           f"set {name}=0 or above n_iters")
    if cfg.trace:
        missing.append("trace (profiler capture, ROADMAP A.3)")
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))


def train(
    cfg: NeRFConfig,
    scene: Scene,
    hooks: Optional[Dict[str, Callable]] = None,
    device: DeviceLike = None,
) -> TrainResult:
    """Run the optimization loop on one device (ref run_nerf.py:534-872):
    the card unless ``device`` says otherwise. The nets start from random
    weights seeded by ``cfg.seed``; the sampler and the per-step draws use
    their own generators on the device, seeded from it too. Every i_print
    steps the loss and PSNR are fetched (the loop's only host sync) and
    printed with the StepTimer's throughput since the previous print.
    ``hooks["on_step"](i, state, aux)`` runs after each step."""
    hooks = hooks or {}
    dev = resolve_device(device)
    _check_supported(cfg, dev)
    expdir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(expdir, exist_ok=True)
    with open(os.path.join(expdir, "args.txt"), "w") as f:
        f.write(dump_config(cfg))

    model = make_model(cfg)
    rs = render_settings_from_config(cfg)
    state = init_train_state(init_nets(model, cfg.seed, dev), cfg.lrate)
    start = state.step

    if cfg.render_only:  # ref run_nerf.py:654-672 (no video: utils/io has none yet)
        poses = scene.poses[scene.i_test] if cfg.render_test else scene.render_poses
        gt = scene.images[scene.i_test] if cfg.render_test else None
        savedir = os.path.join(
            expdir,
            "renderonly_{}_{:06d}".format("test" if cfg.render_test else "path", start),
        )
        os.makedirs(savedir, exist_ok=True)
        render_path(state.nets, model, rs, scene, poses, cfg.chunk, cfg.render_factor,
                    savedir, gt, device=dev)
        return TrainResult(state=state, history=[])

    step_fn = make_train_step(model, rs, cfg.lrate, cfg.lrate_decay,
                              hwf=(scene.H, scene.W, scene.focal))
    sampler = make_sampler(
        scene, cfg, torch.Generator(device=dev).manual_seed(cfg.seed + 1), device=dev
    )
    step_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 2)
    near, far = (0.0, 1.0) if rs.ndc else (scene.near, scene.far)
    near_v = torch.full((cfg.N_rand,), near, dtype=torch.float32, device=dev)
    far_v = torch.full((cfg.N_rand,), far, dtype=torch.float32, device=dev)

    pts_per_ray = 2 * cfg.N_samples + cfg.N_importance if cfg.N_importance > 0 else cfg.N_samples
    timer = StepTimer(
        cfg.N_rand, pts_per_ray,
        flops_per_point(model.coarse, model.pe_pts, model.pe_views or PosEncConfig.identity()),
        peak=device_peak_flops(dev),
    )
    history = []
    anchor = None  # (wall time, step) at the last print: the queue was drained there
    for i in range(start + 1, cfg.n_iters + 1):
        if cfg.no_batching:
            rays_o, rays_d, target = sampler.next_batch(i)
        else:
            rays_o, rays_d, target = sampler.next_batch()
        aux = step_fn(state, rays_o, rays_d, near_v, far_v, target, generator=step_gen)
        if cfg.debug_nan and not bool(torch.isfinite(aux["loss"])):
            raise FloatingPointError(f"non-finite loss at step {i}")  # ref DEBUG, run_nerf.py:414-416
        if i % cfg.i_print == 0:
            loss, psnr = float(aux["loss"]), float(aux["psnr"])  # the fetch waits for step i
            now = time.perf_counter()
            if anchor is None:
                rate = "warmup"
            else:
                rep = timer.report(steps=i - anchor[1], elapsed=now - anchor[0])
                mfu = "" if rep["mfu"] is None else f", {rep['mfu'] * 100:.1f}% MFU"
                rate = f"{rep['rays_per_sec']:,.0f} rays/s{mfu}"
            anchor = (now, i)
            print(f"[TRAIN] Iter: {i} Loss: {loss:.6f}  PSNR: {psnr:.3f}  ({rate})")
            history.append((i, loss, psnr))
        if "on_step" in hooks:
            hooks["on_step"](i, state, aux)
    return TrainResult(state=state, history=history)
