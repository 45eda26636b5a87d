"""The experiment driver: dataset -> model -> optimization loop -> artifacts.

Counterpart of nerf_tpu/train/loop.py (ref ``train()``, run_nerf.py:534-872,
and ``render_path``, run_nerf.py:137-175): ``load_scene`` (blender, llff,
deepvoxels, LINEMOD), the ``args.txt``/``config.txt`` snapshots, resume
from the reference's ``.tar`` (utils/checkpoint.py), the render-only branch
with its video, and the step loop with the i_print, i_img (holdout PSNR),
i_weights (checkpoints), i_video (spiral), i_testset and trace events at
nerf_tpu's steps. On one device, or data-parallel over the ranks of a
process group (parallel/mesh.py; ``cli.train`` launches them): each rank
trains on its rows of every batch, renders its rows of the holdout frame
and its share of the spiral and test frames, and rank 0 prints and writes
the shared files. With ``fuse_steps`` > 1 the loop runs chunks of that
many steps, each one replay of a CUDA graph of the steps on a card
(train/graph.py; nerf_tpu's lax.scan of steps, ROADMAP A.3), the same draws
and updates as step by step: in one process, and over ranks whose group's
collectives a graph can hold (NCCL: each rank replays its graph, the
all-reduces inside, ROADMAP A.3b); on the CPU the chunks run their steps
eagerly. Ranks on cards over gloo step one by one, and say so in a
``[FUSE]`` line (``fuse_refusal``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import shutil
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch.config import NeRFConfig, dump_config
from nerf_tpu_torch.data.rays_dataset import make_sampler
from nerf_tpu_torch.data.scene import Scene
from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.factory import init_nets, make_model
from nerf_tpu_torch.ops.fused_mlp import flops_per_point
from nerf_tpu_torch.parallel import distributed
from nerf_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step, place_state
from nerf_tpu_torch.render.renderer import RenderSettings, make_frame_renderer
from nerf_tpu_torch.train.graph import ChunkRunner
from nerf_tpu_torch.train.step import TrainState, init_train_state, lr_schedule, make_train_step
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
    frame_ids=None,
):
    """Render a pose path in eval mode; returns (rgbs, disps) as numpy
    [M, H, W, ...]. Every frame is rendered with the scene's intrinsics
    ``scene.K``; ``render_factor`` downsamples for previews, dividing H, W
    and K's first two rows by it (as nerf-pytorch divides H, W and focal,
    run_nerf.py:141-145). ``render_frame`` (a make_frame_renderer result)
    may be reused across calls. Writes ``savedir/NNN.png`` per frame when
    given, NNN from ``frame_ids`` (the frames' global ids, default 0..M-1),
    and prints the mean PSNR against ``gt_imgs`` when given."""
    H, W = scene.H, scene.W
    K = np.array(scene.K, np.float32)
    if render_factor != 0:
        # a passed-in render_frame was built at full H/W: rebuild instead
        render_frame = None
        H, W = H // render_factor, W // render_factor
        K[:2] /= render_factor

    rs_eval = rs.eval_mode()
    near, far = (0.0, 1.0) if rs.ndc else (scene.near, scene.far)
    if render_frame is None:
        render_frame = make_frame_renderer(
            model, rs_eval, H, W, K, near, far, chunk=chunk, device=device
        )
    if frame_ids is None:
        frame_ids = list(range(len(poses)))

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
            save_png(os.path.join(savedir, f"{frame_ids[i]:03d}.png"), rgb)

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
    if not rgbs:  # a rank with no frames of its own (render_path_multiprocess)
        return np.zeros((0, H, W, 3), np.float32), np.zeros((0, H, W), np.float32)
    return np.stack(rgbs, 0), np.stack(disps, 0)


def save_path_videos(base: str, rgbs: np.ndarray, disps: np.ndarray) -> None:
    """A path's ``base`` rgb.mp4 and disp.mp4, disp scaled to [0, 1]."""
    save_video(base + "rgb.mp4", rgbs)
    # an empty ray's disp is 1/max(1e-10, 0/0) = nan (the reference's math,
    # run_nerf.py:299): guard only the scaling
    disps = np.nan_to_num(disps, nan=0.0, posinf=0.0)
    save_video(base + "disp.mp4", disps / max(np.max(disps), 1e-10))


def render_path_multiprocess(
    nets,
    model,
    rs: RenderSettings,
    scene: Scene,
    poses: np.ndarray,
    chunk: int,
    stage_dir: str,
    mesh,
    savedir: Optional[str] = None,
    gt_imgs: Optional[np.ndarray] = None,
    render_frame=None,
    video_base: Optional[str] = None,
    device: DeviceLike = None,
) -> None:
    """A pose path shared among the mesh's ranks (nerf_tpu/train/loop.py:148-235):
    rank r renders frames r, r + n, ... with its own (unsharded) frame
    renderer, writes their PNGs under their global ids into ``savedir`` and
    stages their PSNRs against ``gt_imgs`` and, for ``video_base``, their
    arrays in ``stage_dir``. After a barrier rank 0 prints the mean PSNR
    over all frames (in frame order, as render_path takes it), writes
    ``video_base`` rgb.mp4 and disp.mp4 and clears the stage; a second
    barrier keeps the others until it is done. Every rank must call it,
    on a filesystem they share."""
    n = mesh.size
    ids = list(range(mesh.rank, len(poses), n))
    os.makedirs(stage_dir, exist_ok=True)
    rgbs, disps = render_path(nets, model, rs, scene, np.asarray(poses)[ids], chunk,
                              savedir=savedir, render_frame=render_frame, device=device,
                              frame_ids=ids)
    if gt_imgs is not None and ids:
        psnrs = [(fid, psnr_np(rgb, np.asarray(gt_imgs[fid]))) for rgb, fid in zip(rgbs, ids)]
        np.save(os.path.join(stage_dir, f"psnr_{mesh.rank}.npy"), np.asarray(psnrs))
    if video_base is not None:
        for rgb, disp, fid in zip(rgbs, disps, ids):
            np.save(os.path.join(stage_dir, f"rgb_{fid:03d}.npy"), rgb)
            np.save(os.path.join(stage_dir, f"disp_{fid:03d}.npy"), disp)
    distributed.barrier(mesh.group)
    if mesh.is_main:
        if gt_imgs is not None:
            staged = [os.path.join(stage_dir, f"psnr_{r}.npy") for r in range(n)]
            rows = [np.load(f) for f in staged if os.path.exists(f)]
            if rows:
                rows = np.concatenate(rows)
                psnrs = rows[np.argsort(rows[:, 0]), 1]
                print(f"[EVAL] mean PSNR over {len(psnrs)} views ({n} processes): "
                      f"{np.mean(psnrs):.3f}")
        if video_base is not None:
            save_path_videos(video_base, *(
                np.stack([np.load(os.path.join(stage_dir, f"{kind}_{f:03d}.npy"))
                          for f in range(len(poses))])
                for kind in ("rgb", "disp")))
        shutil.rmtree(stage_dir, ignore_errors=True)
    distributed.barrier(mesh.group)


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: list  # [(step, loss, psnr)] at each i_print
    chunks: int = 0  # chunks of fuse_steps run fused (on a card, a graph replay each)


def fuse_refusal(fuse: int, n_ranks: int, device: torch.device,
                 backend: Optional[str]) -> Optional[str]:
    """The ``[FUSE]`` line of a loop asked for chunks of ``fuse`` steps that
    must step one by one on ``device`` over ``n_ranks`` ranks of a
    ``backend`` group (None: one process), or None when it may fuse. One
    process fuses; so do ranks on the CPU, whose chunks run their steps
    eagerly, and ranks on cards whose collectives a CUDA graph can hold
    (``distributed.capturable``: NCCL). Over gloo a card's all-reduce goes
    through the host, so those ranks step one by one, and say so."""
    if backend is None or device.type != "cuda" or distributed.capturable(backend):
        return None
    return (f"[FUSE] fuse_steps={fuse} not fused over {n_ranks} {backend} ranks on cards: "
            f"{backend}'s all-reduce of a card's tensor goes through the host, which a CUDA "
            "graph cannot hold; step by step")


def _data_ranks(cfg: NeRFConfig) -> int:
    """The ranks to train over: ``data_axis``, or with 0 the process group's
    (1 without one). Raises unless the group has exactly that many ranks."""
    world = distributed.world_size()
    n_data = cfg.data_axis if cfg.data_axis > 0 else world
    if n_data != world:
        if world == 1:
            raise ValueError(
                f"data_axis={n_data} needs a process group of {n_data} ranks: run "
                "nerf_tpu_torch.cli.train, which starts them "
                "(nerf_tpu_torch.parallel.distributed.launch), or torchrun")
        raise ValueError(f"data_axis={cfg.data_axis} in a process group of {world} ranks")
    return n_data


def train(
    cfg: NeRFConfig,
    scene: Optional[Scene] = None,
    hooks: Optional[Dict[str, Callable]] = None,
    device: DeviceLike = None,
) -> TrainResult:
    """Run the optimization loop (ref run_nerf.py:534-872) on the card unless
    ``device`` says otherwise; inside a process group of ``data_axis``
    ranks (all of them with 0), data-parallel, each rank on
    ``distributed.rank_device(device)``. The scene is loaded from ``cfg``
    when not given. The nets start from random weights seeded by
    ``cfg.seed``, or from the newest ``.tar`` of the experiment (or
    ``ft_path``) unless ``no_reload``, and then take rank 0's on every rank;
    the sampler and the per-step draws use their own generators on the
    device, seeded from it too (the same on every rank). Every i_print steps
    the loss and PSNR are fetched (a host sync) and printed with the
    StepTimer's throughput since the last sync; the eval renders and
    checkpoints of the other cadences follow at the same step, and their
    time stays out of the throughput. Rank 0 prints and writes the shared
    files. ``hooks["on_step"](i, state, aux)`` runs after each step's
    events."""
    hooks = hooks or {}
    dev = resolve_device(device)
    n_data = _data_ranks(cfg)
    # a group of any size trains over its mesh (a one-rank group all-reduces
    # over itself: the same updates as one process)
    mesh = make_mesh(n_data, device=dev) if distributed.in_group() else None
    if mesh is not None:
        dev = mesh.device
    is_main = mesh is None or mesh.is_main
    if scene is None:
        scene = load_scene(cfg)
    expdir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(expdir, exist_ok=True)
    if is_main:
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
    if mesh is not None:
        state = place_state(mesh, state)
    start = state.step

    if cfg.render_only:  # ref run_nerf.py:654-672
        # over ranks the frames are shared out; a preview (render_factor)
        # is rank 0's alone, as in nerf_tpu
        shared = mesh is not None and cfg.render_factor == 0
        if not is_main and not shared:
            return TrainResult(state=state, history=[])
        poses = scene.poses[scene.i_test] if cfg.render_test else scene.render_poses
        gt = scene.images[scene.i_test] if cfg.render_test else None
        savedir = os.path.join(
            expdir,
            "renderonly_{}_{:06d}".format("test" if cfg.render_test else "path", start),
        )
        os.makedirs(savedir, exist_ok=True)
        if shared:
            render_path_multiprocess(state.nets, model, rs, scene, poses, cfg.chunk,
                                     os.path.join(expdir, ".renderonly_stage"), mesh,
                                     savedir=savedir, gt_imgs=gt,
                                     video_base=os.path.join(savedir, "video_"), device=dev)
        else:
            rgbs, _ = render_path(state.nets, model, rs, scene, poses, cfg.chunk,
                                  cfg.render_factor, savedir, gt, device=dev)
            save_video(os.path.join(savedir, "video.mp4"), rgbs)
        return TrainResult(state=state, history=[])

    if cfg.N_rand % n_data != 0:
        raise ValueError(f"N_rand={cfg.N_rand} must divide evenly over the {n_data} ranks")
    hwf = (scene.H, scene.W, scene.focal)
    if mesh is None:
        step_fn = make_train_step(model, rs, cfg.lrate, cfg.lrate_decay, hwf=hwf)
    else:
        step_fn = make_sharded_train_step(mesh, model, rs, cfg.lrate, cfg.lrate_decay, hwf=hwf)
        if is_main:
            print(f"[MESH] data-parallel over {n_data} ranks: {mesh}")
    sampler = make_sampler(
        scene, cfg, torch.Generator(device=dev).manual_seed(cfg.seed + 1), device=dev, mesh=mesh
    )
    step_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 2)
    near, far = (0.0, 1.0) if rs.ndc else (scene.near, scene.far)
    near_v = torch.full((cfg.N_rand // n_data,), near, dtype=torch.float32, device=dev)
    far_v = torch.full((cfg.N_rand // n_data,), far, dtype=torch.float32, device=dev)

    pts_per_ray = 2 * cfg.N_samples + cfg.N_importance if cfg.N_importance > 0 else cfg.N_samples
    peak = device_peak_flops(dev)
    timer = StepTimer(
        cfg.N_rand, pts_per_ray,
        flops_per_point(model.coarse, model.pe_pts, model.pe_views or PosEncConfig.identity()),
        peak=None if peak is None else peak * n_data,
    )
    frame_renderers = {}  # built at first use, shared by every eval render

    def frame_renderer(sharded: bool = False):
        """The eval frame renderer; ``sharded``: every rank renders its rows
        of one frame (the holdout view), else each rank whole frames."""
        key = sharded and mesh is not None
        if key not in frame_renderers:
            frame_renderers[key] = make_frame_renderer(
                model, rs.eval_mode(), scene.H, scene.W, scene.K, near, far,
                chunk=cfg.chunk, device=dev, mesh=mesh if key else None)
        return frame_renderers[key]

    def render_frames(poses, stage: str, savedir=None, gt_imgs=None, video_base=None):
        """A pose path, shared among the ranks with a mesh (staged in
        ``expdir/.<stage>``); ``video_base``: its rgb and disp videos."""
        if mesh is not None:
            render_path_multiprocess(state.nets, model, rs, scene, poses, cfg.chunk,
                                     os.path.join(expdir, "." + stage), mesh, savedir=savedir,
                                     gt_imgs=gt_imgs, render_frame=frame_renderer(),
                                     video_base=video_base, device=dev)
            return
        rgbs, disps = render_path(state.nets, model, rs, scene, poses, cfg.chunk,
                                  savedir=savedir, gt_imgs=gt_imgs,
                                  render_frame=frame_renderer(), device=dev)
        if video_base is not None:
            save_path_videos(video_base, rgbs, disps)

    holdout_rng = np.random.default_rng(cfg.seed)  # i_img_random's draws
    pbar = None
    if is_main:
        try:
            from tqdm import tqdm

            pbar = tqdm(total=cfg.n_iters - start, desc=cfg.expname)
        except ImportError:
            pass
    # --- the fused loop: k steps of sampler and step as one chunk ---
    # nerf_tpu's fuse_steps (its lax.scan of k steps, nerf_tpu/train/loop.py:
    # 420-511) as a CUDA graph of k steps (train/graph.py), the same draws as
    # the per-step loop's. Chunks never cross a cadence event or the precrop
    # boundary, so every event fires at the same step; a chunk is exactly
    # ``fuse`` steps, anything shorter runs step by step. Over ranks the
    # chunks are the same on every rank (the rule reads only the config),
    # so each rank captures and replays the same all-reduces in one order.
    fuse = max(1, int(cfg.fuse_steps))
    can_fuse = (fuse > 1 and not cfg.trace and "on_step" not in hooks
                and sampler.scan_supported())
    refusal = fuse_refusal(fuse, n_data, dev,
                           None if mesh is None else dist.get_backend(mesh.group))
    if can_fuse and refusal is not None:
        if is_main:
            print(refusal)
        can_fuse = False
    cadences = [c for c in (cfg.i_print, cfg.i_img, cfg.i_weights, cfg.i_video, cfg.i_testset)
                if c > 0]
    if can_fuse and cadences and fuse > min(cadences):
        # a chunk never crosses a cadence event, so a larger fuse would never engage
        if is_main:
            print(f"[FUSE] fuse_steps={fuse} capped to {min(cadences)} "
                  f"(smallest cadence interval)")
        fuse = min(cadences)
        can_fuse = fuse > 1
    runner = None
    if can_fuse:
        schedule = lr_schedule(cfg.lrate, cfg.lrate_decay)
        lr_table = torch.tensor([schedule(state.step + t) for t in range(cfg.n_iters - start)],
                                dtype=torch.float32, device=dev)
        runner = ChunkRunner(functools.partial(step_fn, generator=step_gen), state, fuse, near_v,
                             far_v, [step_gen] + ([sampler.generator] if cfg.no_batching else []),
                             lr_table, state.step)
        if mesh is not None and dev.type == "cuda":
            distributed.connect(mesh.group, dev)  # before the first capture

    def chunk_for(i: int) -> int:
        """Steps a chunk may take from step i (at least 1): up to the next
        cadence event, and in the crop phase up to its last step
        (precrop_iters - 1: the crop is fixed for a chunk)."""
        j = cfg.n_iters
        for c in cadences:
            j = min(j, -(-i // c) * c)  # the first multiple of c at or after i
        if cfg.no_batching and i < sampler.precrop_iters:
            j = min(j, sampler.precrop_iters - 1)
        return max(min(j - i + 1, sampler.max_chunk()), 1)

    def run_chunk(i: int) -> Dict[str, torch.Tensor]:
        if cfg.no_batching:
            phase = "crop" if i < sampler.precrop_iters else "full"
            aux = runner.run(phase, lambda j, _: sampler.next_batch(i + j))
        else:
            aux = runner.run("batch", lambda j, window: sampler.gather(window[j]),
                             sampler.window(fuse))
        sampler.advance(fuse)
        return aux

    # --- the i_print fetch, deferred one interval (nerf_tpu/train/loop.py:
    # 522-573): float() on the step just queued would drain the queue; the
    # previous interval's value is long resident. Rates run from the last
    # drain point, a moment when the device had done exactly ``cum`` steps
    # (an eval's fetch, the trace's sync, or the first print's fresh fetch).
    history = []
    pending = []  # [(step, aux, steps queued by then)]
    cum = 0  # steps queued since the loop began
    anchor = None  # (wall time, cum) at the last drain point

    def flush_print():
        nonlocal anchor
        step_i, p_aux, p_cum = pending.pop()
        loss, psnr = float(p_aux["loss"]), float(p_aux["psnr"])  # waits for p_cum steps
        now = time.perf_counter()
        if anchor is None or p_cum <= anchor[1]:
            rate = "warmup"
            if p_cum == cum:  # the freshest step's value: the queue is drained
                anchor = (now, p_cum)
        else:
            rep = timer.report(steps=p_cum - anchor[1], elapsed=now - anchor[0])
            mfu = "" if rep["mfu"] is None else f", {rep['mfu'] * 100:.1f}% MFU"
            rate = f"{rep['rays_per_sec']:,.0f} rays/s{mfu}"
        if is_main:
            print(f"[TRAIN] Iter: {step_i} Loss: {loss:.6f}  PSNR: {psnr:.3f}  ({rate})")
        history.append((step_i, loss, psnr))

    i = start + 1
    chunks = 0
    try:
        while i <= cfg.n_iters:
            k = chunk_for(i) if can_fuse else 1
            if can_fuse and k >= fuse:
                k = fuse
                chunk = run_chunk(i)
                chunks += 1
                aux = {name: v[-1] for name, v in chunk.items()}
                losses = chunk["loss"]
            else:
                k = 1
                if cfg.no_batching:
                    rays_o, rays_d, target = sampler.next_batch(i)
                else:
                    rays_o, rays_d, target = sampler.next_batch()
                aux = step_fn(state, rays_o, rays_d, near_v, far_v, target, generator=step_gen)
                losses = aux["loss"]
            i += k - 1  # the last step made: its events fire below
            cum += k
            if pbar is not None:
                pbar.update(k)
            if cfg.debug_nan and not bool(torch.isfinite(losses).all()):
                # ref DEBUG, run_nerf.py:414-416 (here it also stops)
                raise FloatingPointError(f"non-finite loss by step {i}")
            if cfg.trace and i == start + 12:
                # steady state: capture 4 more steps on this step's batch, as
                # nerf_tpu does (state.step moves by 4 here, i does not);
                # every rank steps, rank 0 writes the trace
                tracing = (trace(os.path.join(expdir, "trace")) if is_main
                           else contextlib.nullcontext())
                with tracing:
                    for _ in range(4):
                        aux = step_fn(state, rays_o, rays_d, near_v, far_v, target,
                                      generator=step_gen)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                cum += 4
                anchor = (time.perf_counter(), cum)
                if is_main:
                    print(f"[TRACE] profile written to {expdir}/trace")
            if i % cfg.i_print == 0:
                if pending:
                    flush_print()
                pending.append((i, aux, cum))
                if anchor is None:
                    # no drain point yet: fetch this value now, once, so that
                    # later windows start from an exact device state
                    flush_print()
            evals = [cfg.i_img > 0 and i % cfg.i_img == 0 and len(scene.i_val),
                     cfg.i_weights > 0 and i % cfg.i_weights == 0,
                     cfg.i_video > 0 and i % cfg.i_video == 0,
                     cfg.i_testset > 0 and i % cfg.i_testset == 0 and len(scene.i_test)]
            if pending and any(evals):
                flush_print()  # before the eval's lines, its window train-only
            if evals[0]:
                # the holdout view: cycled, or drawn as the reference does
                # (np.random.choice, run_nerf.py:836-840) with i_img_random;
                # over ranks each renders its rows of it (nerf_tpu's sharded eval)
                if cfg.i_img_random:
                    img_i = int(holdout_rng.choice(np.asarray(scene.i_val)))
                else:
                    img_i = int(np.asarray(scene.i_val)[i // cfg.i_img % len(scene.i_val)])
                out = frame_renderer(sharded=True)(state.nets, scene.poses[img_i][:3, :4])
                if is_main:
                    gt = torch.as_tensor(scene.images[img_i], device=dev)
                    holdout_psnr = float(mse2psnr(img2mse(out["rgb_map"], gt)))
                    print(f"[EVAL] Iter: {i} holdout view {img_i} PSNR: {holdout_psnr:.3f}")
            if evals[1]:
                path = ckpt_lib.save_checkpoint(cfg.basedir, cfg.expname, state, mesh)
                if is_main:
                    print("Saved checkpoints at", path)
            if evals[2]:
                render_frames(scene.render_poses, f"video_{i:06d}",
                              video_base=os.path.join(expdir, f"{cfg.expname}_spiral_{i:06d}_"))
            if evals[3]:
                testsavedir = os.path.join(expdir, f"testset_{i:06d}")
                os.makedirs(testsavedir, exist_ok=True)
                render_frames(scene.poses[scene.i_test], f"testset_{i:06d}",
                              savedir=testsavedir, gt_imgs=scene.images[scene.i_test])
            if any(evals):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                anchor = (time.perf_counter(), cum)  # keep eval time out of the rate
            if "on_step" in hooks:
                hooks["on_step"](i, state, aux)
            i += 1
        if pending:
            flush_print()  # the last interval's
    finally:
        if pbar is not None:
            pbar.close()
    return TrainResult(state=state, history=history, chunks=chunks)
