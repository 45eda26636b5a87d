"""One rank of tests/test_torch_port_parallel.py's process group.

``rank_run`` runs in each gloo rank that the test starts with
``nerf_tpu_torch.parallel.distributed.launch``: data-parallel training
(fused, then the same runs step by step, on both sampler policies), the
sharded step (with the schedule's float and with an ``lr`` tensor), the
samplers and the frame renderer, then multi-scene training with the scene
axis over the ranks. ``tp_rank`` runs in each of the four ranks of the
DP×TP fixture (data 2 × model 2): the sharded step without draws and with
them, the mesh-sharded frame through the model-parallel nets, and the
model-parallel MLP's gradients against the whole MLP's. It
imports torch and the port only (a spawned rank imports this module afresh)
and returns CPU tensors and numbers for the test to hold against one
process and nerf_tpu.
"""

import contextlib
import io

import torch

from nerf_tpu_torch.cli import train as cli_train
from nerf_tpu_torch.cli import train_multi
from nerf_tpu_torch.data import rays_dataset
from nerf_tpu_torch.data.blender import load_blender_scene
from nerf_tpu_torch.models.factory import make_model
from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
from nerf_tpu_torch.parallel.mesh import (
    gather_state, make_mesh, make_sharded_train_step, place_state, shard_batch, shard_state,
)
from nerf_tpu_torch.parallel.tensor_parallel import ShardedNeRFMLP, gather_rows
from nerf_tpu_torch.render.renderer import make_frame_renderer
from nerf_tpu_torch.train.loop import render_settings_from_config
from nerf_tpu_torch.train.step import init_train_state, lr_schedule


def state_tensors(state) -> dict:
    """A train state's parameters and Adam moments, by level and name, and its step."""
    out = {"step": state.step, "params": {}, "moments": {}}
    for level, net in state.nets.items():
        out["params"][level] = {n: p.detach().cpu().clone() for n, p in net.named_parameters()}
        out["moments"][level] = {
            n: tuple(state.optimizer.state[p][k].cpu().clone() for k in ("exp_avg", "exp_avg_sq"))
            for n, p in net.named_parameters() if p in state.optimizer.state}
    return out


def rank_run(device, job: dict) -> dict:
    out = {}
    # cli.train inside the group: this rank's share of data-parallel training
    result = cli_train.main(job["argv"], device=device)
    out["history"] = result.history
    out["state"] = state_tensors(result.state)
    out["chunks"] = result.chunks
    # the fused loop against the same ranks step by step: each policy's
    # (fused, per-step) runs, their lines kept out of the test's log; the
    # image policy's fused run is the one above
    out["fuse"] = {}
    for policy, (fused, per_step) in job["fuse_argvs"].items():
        with contextlib.redirect_stdout(io.StringIO()):
            runs = [result if fused is None else cli_train.main(fused, device=device),
                    cli_train.main(per_step, device=device)]
        out["fuse"][policy] = [{"history": r.history, "state": state_tensors(r.state),
                                "chunks": r.chunks} for r in runs]
    cfg, scene_args = job["cfg"], job["scene"]
    mesh = make_mesh(2, device=device)
    model = make_model(cfg)
    rs = render_settings_from_config(cfg)

    # nerf_tpu's shard_map step, as the port runs it: given state, rays and
    # the whole batch's draws
    step = make_sharded_train_step(mesh, model, rs, cfg.lrate, cfg.lrate_decay)
    schedule = lr_schedule(cfg.lrate, cfg.lrate_decay)
    for key, lr_scale in (("step", None), ("step_lr_tensor", 1.0), ("step_lr_double", 2.0)):
        # the same steps with the schedule's float and with a float32 tensor
        # of it (the fused loop's learning-rate table), or of twice it
        state = init_train_state({lvl: NeRFMLP(getattr(model, lvl), device=device)
                                  for lvl in job["step"]["params"]}, cfg.lrate)
        for level, sd in job["step"]["params"].items():
            state.nets[level].load_state_dict(sd, strict=True)
        losses = []
        for batch, overrides in job["step"]["batches"]:
            rows = shard_batch(mesh, *(torch.from_numpy(a) for a in batch))
            lr = (None if lr_scale is None else
                  torch.tensor(lr_scale * schedule(state.step), dtype=torch.float32,
                               device=device))
            aux = step(state, *rows, lr=lr,
                       overrides={k: torch.from_numpy(v) for k, v in overrides.items()})
            losses.append(float(aux["loss"]))
        out[key] = {"losses": losses, "state": state_tensors(state)}

    # both samplers: this rank's rows of each batch, across an epoch wrap
    scene = load_blender_scene(*scene_args)
    n_rand, n_batches = job["sampler"]
    batched = rays_dataset.BatchedRaySampler(
        scene, n_rand, torch.Generator().manual_seed(5), device=device, mesh=mesh)
    image = rays_dataset.ImageRaySampler(
        scene, n_rand, torch.Generator().manual_seed(6), precrop_iters=2, device=device,
        mesh=mesh)
    out["batched"] = [batched.next_batch() for _ in range(n_batches)]
    out["image"] = [image.next_batch(i) for i in range(1, 5)]

    # the mesh-sharded frame renderer at an odd H*W, with the trained nets
    H, W = job["frame_hw"]
    frame = make_frame_renderer(model, rs.eval_mode(), H, W, scene.K, scene.near, scene.far,
                                chunk=job["chunk"], device=device, mesh=mesh)
    out["frame"] = frame(result.state.nets, scene.poses[0])
    out["rank"] = mesh.rank

    # cli.train_multi inside the group: this rank's scene of the two, with
    # no collective
    multi = train_multi.main(job["multi_argv"], device=device)
    out["multi"] = {"scenes": multi.scenes, "history": multi.history,
                    "state": state_tensors(multi.state)}
    return out



def sharded_step_rank(device, job: dict) -> dict:
    """tests/test_torch_port_kernels.py's card check: the sharded step on
    this rank's rows of ``job``'s batches, with K1's and K4's launches."""
    from nerf_tpu_torch.ops import fused_mlp

    mesh = make_mesh(2, device=device)
    model = job["model"]
    nets = {}
    for level, sd in job["params"].items():
        nets[level] = NeRFMLP(getattr(model, level), device=device)
        nets[level].load_state_dict(sd, strict=True)
    state = init_train_state(nets, job["lrate"])
    step = make_sharded_train_step(mesh, model, job["rs"], job["lrate"], job["lrate_decay"])
    before = fused_mlp.fused_rays_planes.launches, fused_mlp.fused_rays_planes_bwd.launches
    losses = []
    for batch, overrides in job["batches"]:
        rows = shard_batch(mesh, *(torch.from_numpy(a).to(device) for a in batch))
        aux = step(state, *rows,
                   overrides={k: torch.from_numpy(v).to(device) for k, v in overrides.items()})
        losses.append(float(aux["loss"]))
    launches = (fused_mlp.fused_rays_planes.launches - before[0],
                fused_mlp.fused_rays_planes_bwd.launches - before[1])
    return {"losses": losses, "launches": launches, "state": state_tensors(state)}


def train_rank(device, argv) -> dict:
    """``cli.train.main(argv)`` in this rank's group: its history, state,
    fused chunks and printed lines."""
    with contextlib.redirect_stdout(io.StringIO()) as log:
        result = cli_train.main(argv, device=device)
    return {"history": result.history, "state": state_tensors(result.state),
            "chunks": result.chunks, "log": log.getvalue()}


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def tp_rank(device, job: dict) -> dict:
    """The DP×TP step on a data 2 × model 2 mesh: ``job["runs"]`` names each
    run's render settings, seed (None: no draws) and batches; every run
    starts from ``job["params"]`` through ``place_state`` and
    ``shard_state`` and returns its losses and ``gather_state``; the run
    without draws then renders ``job["frame"]`` on the mesh. Then the
    model-parallel MLP against the whole one on ``job["grad_check"]``'s
    inputs: the largest difference of the outputs and, per parameter, of
    the gathered gradients."""
    mesh = make_mesh(2, 2, device=device)
    model = job["model"]
    out = {"rank": mesh.rank, "data_index": mesh.data_index, "model_index": mesh.model_index}
    for key, (rs, seed, batches) in job["runs"].items():
        nets = {}
        for level, sd in job["params"].items():
            nets[level] = NeRFMLP(getattr(model, level), device=device)
            nets[level].load_state_dict(sd, strict=True)
        state = shard_state(mesh, place_state(mesh, init_train_state(nets, job["lrate"])))
        step = make_sharded_train_step(mesh, model, rs, job["lrate"], job["lrate_decay"],
                                       shard_model_axis=True)
        gen = None if seed is None else torch.Generator(device).manual_seed(seed)
        losses = []
        for batch in batches:
            rows = shard_batch(mesh, *(torch.from_numpy(a).to(device) for a in batch))
            losses.append(float(step(state, *rows, generator=gen)["loss"]))
        out[key] = {"losses": losses, "state": _cpu(gather_state(mesh, state)),
                    "rows": {lvl: {n: tuple(p.shape) for n, p in net.named_parameters()}
                             for lvl, net in state.nets.items()}}
        if key == "det":  # the mesh-sharded frame through the model-parallel nets
            H, W, K, pose = job["frame"]
            frame = make_frame_renderer(model, rs.eval_mode(), H, W, K, 2.0, 6.0, chunk=40,
                                        device=device, mesh=mesh)
            out["frame"] = _cpu(frame(state.nets, pose))

    out["grad_check"] = {}
    for name, (cfg, x, v, cot) in job["grad_check"].items():
        whole = NeRFMLP(cfg, seed=5, device=device)
        sharded = ShardedNeRFMLP(whole, mesh)
        x, cot = torch.from_numpy(x).to(device), torch.from_numpy(cot).to(device)
        v = None if v is None else torch.from_numpy(v).to(device)
        y_whole, y_sharded = whole.apply_mlp(x, v), sharded.apply_mlp(x, v)
        (y_whole * cot).sum().backward()
        (y_sharded * cot).sum().backward()
        errs = {"out": float((y_whole - y_sharded).detach().abs().max())}
        grads = dict(whole.named_parameters())
        for pname, p in sharded.named_parameters():
            ref = grads[pname].grad
            if p.grad is None or ref is None:  # the unused view layer without viewdirs
                errs[pname] = 0.0 if p.grad is None and ref is None else float("inf")
                continue
            g = gather_rows(p.grad, mesh) if sharded.sharded[pname] else p.grad
            errs[pname] = float((g - ref).abs().max())
        out["grad_check"][name] = errs
    return out
