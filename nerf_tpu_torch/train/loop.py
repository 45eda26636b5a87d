"""The experiment driver: dataset -> model -> optimization loop -> artifacts.

Counterpart of nerf_tpu/train/loop.py (ref ``train()``, run_nerf.py:534-872,
and ``render_path``, run_nerf.py:137-175), for one device: ``load_scene``
(blender, llff, deepvoxels, LINEMOD), the ``args.txt``/``config.txt``
snapshots, resume from the reference's ``.tar`` (utils/checkpoint.py), the
render-only branch with its video, and the step loop with the i_print,
i_img (holdout PSNR), i_weights (checkpoints), i_video (spiral), i_testset
and trace events at nerf_tpu's steps. nerf_tpu's ``fuse_steps`` (a
lax.scan of steps) is ignored: its counterpart is a CUDA graph of the step
(ROADMAP A.3).
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
from nerf_tpu_torch.utils import checkpoint as ckpt_lib
from nerf_tpu_torch.utils.io import save_png, save_video
from nerf_tpu_torch.utils.metrics import img2mse, mse2psnr, psnr_np
from nerf_tpu_torch.utils.profiler import StepTimer, device_peak_flops, trace


def load_scene(cfg: NeRFConfig) -> Scene:
    """Dataset dispatch (ref run_nerf.py:541-608)."""
    if cfg.dataset_type == "blender":
        from nerf_tpu_torch.data.blender import load_blender_scene

        return load_blender_scene(cfg.datadir, cfg.half_res, cfg.testskip, cfg.white_bkgd)
    if cfg.dataset_type == "llff":
        from nerf_tpu_torch.data.llff import load_llff_scene

        return load_llff_scene(
            cfg.datadir,
            factor=cfg.factor,
            spherify=cfg.spherify,
            llffhold=cfg.llffhold,
            no_ndc=cfg.no_ndc,
        )
    if cfg.dataset_type == "deepvoxels":
        from nerf_tpu_torch.data.deepvoxels import load_deepvoxels_scene

        return load_deepvoxels_scene(cfg.datadir, cfg.shape, cfg.testskip)
    if cfg.dataset_type == "LINEMOD":
        from nerf_tpu_torch.data.linemod import load_linemod_scene

        return load_linemod_scene(cfg.datadir, cfg.half_res, cfg.testskip, cfg.white_bkgd)
    raise ValueError(f"Unknown dataset type: {cfg.dataset_type}")


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
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if cfg.data_axis > 1 or (cfg.data_axis == 0 and n_cards > 1):
        raise NotImplementedError("not ported yet: data parallelism over several devices "
                                  "(ROADMAP A.8); set data_axis=1")


def train(
    cfg: NeRFConfig,
    scene: Optional[Scene] = None,
    hooks: Optional[Dict[str, Callable]] = None,
    device: DeviceLike = None,
) -> TrainResult:
    """Run the optimization loop on one device (ref run_nerf.py:534-872):
    the card unless ``device`` says otherwise. The scene is loaded from
    ``cfg`` when not given. The nets start from random weights seeded by
    ``cfg.seed``, or from the newest ``.tar`` of the experiment (or
    ``ft_path``) unless ``no_reload``; the sampler and the per-step draws
    use their own generators on the device, seeded from it too. Every
    i_print steps the loss and PSNR are fetched (a host sync) and printed
    with the StepTimer's throughput since the last sync; the eval renders
    and checkpoints of the other cadences follow at the same step, and
    their time stays out of the throughput. ``hooks["on_step"](i, state,
    aux)`` runs after each step's events."""
    hooks = hooks or {}
    dev = resolve_device(device)
    _check_supported(cfg, dev)
    if scene is None:
        scene = load_scene(cfg)
    expdir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(expdir, exist_ok=True)
    with open(os.path.join(expdir, "args.txt"), "w") as f:
        f.write(dump_config(cfg))
    if cfg.config is not None and os.path.exists(cfg.config):
        with open(cfg.config) as src, open(os.path.join(expdir, "config.txt"), "w") as f:
            f.write(src.read())

    model = make_model(cfg)
    rs = render_settings_from_config(cfg)
    state = init_train_state(init_nets(model, cfg.seed, dev), cfg.lrate)
    state = ckpt_lib.maybe_resume(cfg.basedir, cfg.expname, state, model, cfg.lrate,
                                  cfg.no_reload, cfg.ft_path, device=dev)
    start = state.step

    if cfg.render_only:  # ref run_nerf.py:654-672
        poses = scene.poses[scene.i_test] if cfg.render_test else scene.render_poses
        gt = scene.images[scene.i_test] if cfg.render_test else None
        savedir = os.path.join(
            expdir,
            "renderonly_{}_{:06d}".format("test" if cfg.render_test else "path", start),
        )
        os.makedirs(savedir, exist_ok=True)
        rgbs, _ = render_path(state.nets, model, rs, scene, poses, cfg.chunk, cfg.render_factor,
                              savedir, gt, device=dev)
        save_video(os.path.join(savedir, "video.mp4"), rgbs)
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
    frame_renderers = []  # one frame renderer shared by every eval render

    def frame_renderer():
        if not frame_renderers:
            frame_renderers.append(make_frame_renderer(
                model, rs.eval_mode(), scene.H, scene.W, scene.K, near, far,
                chunk=cfg.chunk, device=dev))
        return frame_renderers[0]

    holdout_rng = np.random.default_rng(cfg.seed)  # i_img_random's draws
    try:
        from tqdm import tqdm

        pbar = tqdm(total=cfg.n_iters - start, desc=cfg.expname)
    except ImportError:
        pbar = None
    history = []
    anchor = None  # (wall time, step) where the queue was last drained
    try:
        for i in range(start + 1, cfg.n_iters + 1):
            if cfg.no_batching:
                rays_o, rays_d, target = sampler.next_batch(i)
            else:
                rays_o, rays_d, target = sampler.next_batch()
            aux = step_fn(state, rays_o, rays_d, near_v, far_v, target, generator=step_gen)
            if pbar is not None:
                pbar.update(1)
            if cfg.debug_nan and not bool(torch.isfinite(aux["loss"])):
                raise FloatingPointError(f"non-finite loss at step {i}")  # ref DEBUG, run_nerf.py:414-416
            if cfg.trace and i == start + 12:
                # steady state: capture 4 more steps on this step's batch, as
                # nerf_tpu does (state.step moves by 4 here, i does not)
                with trace(os.path.join(expdir, "trace")):
                    for _ in range(4):
                        aux = step_fn(state, rays_o, rays_d, near_v, far_v, target,
                                      generator=step_gen)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                anchor = (time.perf_counter(), i)
                print(f"[TRACE] profile written to {expdir}/trace")
            if i % cfg.i_print == 0:
                loss, psnr = float(aux["loss"]), float(aux["psnr"])  # the fetch waits for step i
                now = time.perf_counter()
                if anchor is None or anchor[1] == i:
                    rate = "warmup"
                else:
                    rep = timer.report(steps=i - anchor[1], elapsed=now - anchor[0])
                    mfu = "" if rep["mfu"] is None else f", {rep['mfu'] * 100:.1f}% MFU"
                    rate = f"{rep['rays_per_sec']:,.0f} rays/s{mfu}"
                anchor = (now, i)
                print(f"[TRAIN] Iter: {i} Loss: {loss:.6f}  PSNR: {psnr:.3f}  ({rate})")
                history.append((i, loss, psnr))
            drained = False  # did an eval or a save fetch from the device?
            if cfg.i_img > 0 and i % cfg.i_img == 0 and len(scene.i_val):
                # the holdout view: cycled, or drawn as the reference does
                # (np.random.choice, run_nerf.py:836-840) with i_img_random
                if cfg.i_img_random:
                    img_i = int(holdout_rng.choice(np.asarray(scene.i_val)))
                else:
                    img_i = int(np.asarray(scene.i_val)[i // cfg.i_img % len(scene.i_val)])
                out = frame_renderer()(state.nets, scene.poses[img_i][:3, :4])
                gt = torch.as_tensor(scene.images[img_i], device=dev)
                holdout_psnr = float(mse2psnr(img2mse(out["rgb_map"], gt)))
                print(f"[EVAL] Iter: {i} holdout view {img_i} PSNR: {holdout_psnr:.3f}")
                drained = True
            if cfg.i_weights > 0 and i % cfg.i_weights == 0:
                path = ckpt_lib.save_checkpoint(cfg.basedir, cfg.expname, state)
                print("Saved checkpoints at", path)
                drained = True
            if cfg.i_video > 0 and i % cfg.i_video == 0:
                base = os.path.join(expdir, f"{cfg.expname}_spiral_{i:06d}_")
                rgbs, disps = render_path(state.nets, model, rs, scene, scene.render_poses,
                                          cfg.chunk, render_frame=frame_renderer(), device=dev)
                save_video(base + "rgb.mp4", rgbs)
                # an empty ray's disp is 1/max(1e-10, 0/0) = nan (the
                # reference's math, run_nerf.py:299): guard only the scaling
                disps = np.nan_to_num(disps, nan=0.0, posinf=0.0)
                save_video(base + "disp.mp4", disps / max(np.max(disps), 1e-10))
                drained = True
            if cfg.i_testset > 0 and i % cfg.i_testset == 0 and len(scene.i_test):
                testsavedir = os.path.join(expdir, f"testset_{i:06d}")
                os.makedirs(testsavedir, exist_ok=True)
                render_path(state.nets, model, rs, scene, scene.poses[scene.i_test], cfg.chunk,
                            savedir=testsavedir, gt_imgs=scene.images[scene.i_test],
                            render_frame=frame_renderer(), device=dev)
                drained = True
            if drained:
                anchor = (time.perf_counter(), i)  # keep eval time out of the rate
            if "on_step" in hooks:
                hooks["on_step"](i, state, aux)
    finally:
        if pbar is not None:
            pbar.close()
    return TrainResult(state=state, history=history)
