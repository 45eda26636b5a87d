"""The training step.

Counterpart of nerf_tpu/train/step.py, the reference's loop body
(run_nerf.py:759-784): coarse+fine render, ``loss = mse(fine) +
mse(coarse)`` (run_nerf.py:765-772), the backward, and Adam with the decay
``lr = lrate * 0.1^(t/(lrate_decay*1000))`` (run_nerf.py:780-784).

The step runs eagerly on the device of its tensors: the random draws, both
levels' fused forward and backward (K1/K4 at sample counts that are
multiples of 8, K2/K3 otherwise; K5/K6, compositing included, with
``fused_render``), compositing and Adam are queued there without a host
sync; the loss comes back as a device tensor in ``aux``. With a process
group (parallel/mesh.py) the step is nerf_tpu's shard_map body
(``make_train_step_core(axis_name=...)``): the gradients and loss terms are
averaged over the ranks of the group before Adam. That group is the mesh's
data group: every rank when the mesh has one model index; in the DP×TP step
(n_model > 1) the ranks of this rank's model index, whose nets hold the same
rows of each sharded layer (parallel/tensor_parallel.py), while the model
group's collectives run inside the nets' forward and backward. ``make_stacked_train_step`` is the
step of S scenes at once (multi-scene training, parallel/multi_scene.py):
nerf_tpu's step vmapped over a scene axis, with each scene's (H, W, focal)
an operand for NDC scenes (its ``hwf_operand``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from nerf_tpu_torch.geom.rays import ndc_rays
from nerf_tpu_torch.render.network import NeRFModel
from nerf_tpu_torch.render.renderer import RenderSettings, render_rays
from nerf_tpu_torch.utils.metrics import img2mse, mse2psnr

ADAM_BETAS = (0.9, 0.999)  # ref run_nerf.py:207
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    """The networks, their Adam optimizer and the number of updates made."""

    nets: Dict[str, torch.nn.Module]
    optimizer: torch.optim.Adam
    step: int = 0


def lr_schedule(lrate: float, lrate_decay: int) -> Callable[[int], float]:
    """lr(t) = lrate * 0.1^(t / (lrate_decay*1000)) for update t (ref
    run_nerf.py:780-784; optax's exponential_decay as nerf_tpu builds it):
    the first update, t = 0, uses lrate."""

    def lr(t: int) -> float:
        return lrate * 0.1 ** (t / (lrate_decay * 1000))

    return lr


def init_train_state(
    nets: Dict[str, torch.nn.Module], lrate, start_step: int = 0
) -> TrainState:
    """The nets with Adam(betas=(0.9, 0.999), eps=1e-8) over every parameter,
    coarse first. torch's Adam, like optax's, adds eps after the
    bias-corrected root. Its learning rate is a float32 tensor on the nets'
    device that each step sets (``set_lr``), and on a card the optimizer is
    capturable (its step counts device tensors too), so that a CUDA graph
    holds whole steps (train/graph.py); the per-step loop uses the same
    optimizer, and the two loops make the same updates bit for bit."""
    params = [p for level in ("coarse", "fine") if level in nets for p in nets[level].parameters()]
    dev = params[0].device
    lr = torch.tensor(float(lrate), dtype=torch.float32, device=dev)
    optimizer = torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                                 capturable=dev.type == "cuda")
    return TrainState(nets=nets, optimizer=optimizer, step=start_step)


def set_lr(optimizer: torch.optim.Optimizer, lr) -> None:
    """Write ``lr``, a float or a 0-dim tensor on the device (a graph's
    input), into every param group's learning-rate tensor
    (``init_train_state``'s): the float rounds to float32 as the tensor's
    value did, so both give the optimizer the same bits."""
    for group in optimizer.param_groups:
        if isinstance(lr, torch.Tensor):
            group["lr"].copy_(lr)
        else:
            group["lr"].fill_(lr)


def adam_step_count(optimizer: torch.optim.Optimizer, count: float,
                    like: torch.Tensor) -> torch.Tensor:
    """Adam's ``step`` entry holding ``count`` where torch's Adam keeps it:
    on the parameter's device when the optimizer is capturable, else a CPU
    float32 scalar. A ``.tar`` holds it as a CPU scalar whatever the device
    (utils/checkpoint.py)."""
    dev = like.device if optimizer.defaults["capturable"] else "cpu"
    return torch.tensor(float(count), dtype=torch.float32, device=dev)


def draw_overrides(
    generator: torch.Generator, n_rays: int, rs: RenderSettings
) -> Dict[str, torch.Tensor]:
    """Every random stream ``render_rays`` consumes, drawn on the generator's
    device in nerf_tpu's order and shapes (jitter, coarse noise, importance
    u, fine noise; nerf_tpu/train/step.py:75-110)."""
    dev = generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev, dtype=torch.float32)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)

    ov: Dict[str, torch.Tensor] = {}
    if rs.perturb:
        ov["t_rand"] = uniform(n_rays, rs.n_samples)
    if rs.raw_noise_std > 0.0:
        ov["noise0"] = normal(n_rays, rs.n_samples) * rs.raw_noise_std
    if rs.n_importance > 0:
        if rs.perturb:  # det (perturb == 0) uses linspace: no draw
            ov["u"] = uniform(n_rays, rs.n_importance)
        if rs.raw_noise_std > 0.0:
            ov["noise1"] = normal(n_rays, rs.n_samples + rs.n_importance) * rs.raw_noise_std
    return ov


def loss_fn(
    nets: Mapping[str, torch.nn.Module],
    model: NeRFModel,
    rs: RenderSettings,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
    near: torch.Tensor,
    far: torch.Tensor,
    target: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    overrides: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out = render_rays(
        nets, model, rs, rays_o, rays_d, viewdirs, near, far,
        generator=generator, overrides=overrides,
    )
    img_loss = img2mse(out["rgb_map"], target)
    loss = img_loss
    aux = {"psnr": mse2psnr(img_loss), "img_loss": img_loss}
    if "rgb0" in out:  # coarse term only with a fine level (ref run_nerf.py:770-772)
        img_loss0 = img2mse(out["rgb0"], target)
        loss = loss + img_loss0
        aux["img_loss0"] = img_loss0
        aux["psnr0"] = mse2psnr(img_loss0)
    aux["loss"] = loss
    return loss, aux


class _GradMean:
    """The gradients' all-reduce (a mean over the group's ranks), a level at
    a time, fine first, as nerf_tpu's per-level ``pmean`` (step.py:188-212).
    Each level's gradients go through one flat buffer that lives for the
    run; a gradient that is None (a parameter the loss does not reach) goes
    in as zeros, and every parameter's ``.grad`` is then a view of the
    reduced buffer. A CUDA graph can hold it (train/graph.py's chunks over
    NCCL ranks): the buffers are made at the first step, outside any
    capture, and stay; nothing reads a value on the host; each
    ``all_reduce`` is waited for on the current stream, so its ``div_``
    and everything after it follow it there."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.buffers: Dict[str, Tuple[list, torch.Tensor, list]] = {}

    def _buffer(self, level: str, params: list):
        held = self.buffers.get(level)
        if held is None or len(held[0]) != len(params) or \
                any(a is not b for a, b in zip(held[0], params)):
            flat = torch.empty(sum(p.numel() for p in params), dtype=params[0].dtype,
                               device=params[0].device)
            views, offset = [], 0
            for p in params:
                views.append(flat[offset : offset + p.numel()].view_as(p))
                offset += p.numel()
            held = self.buffers[level] = (params, flat, views)
        return held

    def grads(self, nets: Mapping[str, torch.nn.Module]) -> None:
        for level in [k for k in ("fine", "coarse") if k in nets]:
            params, flat, views = self._buffer(level, list(nets[level].parameters()))
            for p, v in zip(params, views):
                if p.grad is None:
                    v.zero_()
                else:
                    v.copy_(p.grad)
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.size)
            for p, v in zip(params, views):
                p.grad = v

    def aux(self, aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The loss terms averaged over the group, and the PSNRs recomputed
        from the averaged mse (a mean of PSNRs is not the batch's PSNR;
        nerf_tpu step.py:213-218)."""
        keys = [k for k in ("img_loss", "img_loss0", "loss") if k in aux]
        mean = torch.stack([aux[k] for k in keys])
        dist.all_reduce(mean, group=self.group)
        mean.div_(self.size)
        aux = {**aux, **dict(zip(keys, mean.unbind()))}
        aux["psnr"] = mse2psnr(aux["img_loss"])
        if "img_loss0" in aux:
            aux["psnr0"] = mse2psnr(aux["img_loss0"])
        return aux


def make_train_step(
    model: NeRFModel,
    rs: RenderSettings,
    lrate: float,
    lrate_decay: int,
    hwf=None,
    group=None,
):
    """The train step: ``step(state, rays_o, rays_d, near, far, target,
    generator=None, overrides=None) -> aux`` updates ``state`` in place
    (parameters, Adam moments, ``step``) and returns detached device
    tensors (loss, psnr, ...). The random draws come from ``overrides`` when
    given, else from ``generator``. The learning rate is ``lr`` (a 0-dim
    device tensor: train/graph.py's input) when given, else the schedule's
    at ``state.step``. Viewdirs come from the raw rays_d, before
    the NDC transform (ref run_nerf.py:102-114); ``hwf=(H, W, focal)`` is
    needed when rs.ndc. With a process ``group`` the rays are this rank's
    shard: the gradients and the loss terms are averaged over the group
    before Adam (``_GradMean``), so every rank makes the same update and
    ``aux`` is the whole batch's (parallel/mesh.py draws and slices)."""
    if rs.ndc and hwf is None:
        raise ValueError("rs.ndc=True requires hwf=(H, W, focal)")
    schedule = lr_schedule(lrate, lrate_decay)
    mean = None if group is None else _GradMean(group)

    def step(state: TrainState, rays_o, rays_d, near, far, target, generator=None,
             overrides=None, lr=None) -> Dict[str, torch.Tensor]:
        if overrides is None and generator is not None:
            overrides = draw_overrides(generator, rays_o.shape[0], rs)
        viewdirs = None
        if rs.use_viewdirs:
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if rs.ndc:
            H, W, focal = hwf
            rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
        set_lr(state.optimizer, schedule(state.step) if lr is None else lr)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(
            state.nets, model, rs, rays_o, rays_d, viewdirs, near, far, target,
            generator=generator, overrides=overrides,
        )
        loss.backward()
        aux = {k: v.detach() for k, v in aux.items()}
        if mean is not None:
            mean.grads(state.nets)
            aux = mean.aux(aux)
        state.optimizer.step()
        state.step += 1
        return aux

    return step


def stacked_loss_fn(
    nets: Mapping[str, torch.nn.Module],
    model: NeRFModel,
    rs: RenderSettings,
    n_scenes: int,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
    near: torch.Tensor,
    far: torch.Tensor,
    target: torch.Tensor,
    overrides: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``loss_fn`` for S scenes at once: stacked nets (StackedNeRFMLP) and
    the rays of the scenes one after another, [S*R]. Each aux value is one
    a scene, [S]: its mean mse (and PSNR) over its own rays, as its own
    ``loss_fn`` would give it. The returned loss is their sum, so scene s's
    grads are those of its own loss (no other term reaches its net)."""
    out = render_rays(nets, model, rs, rays_o, rays_d, viewdirs, near, far,
                      overrides=overrides)

    def mse(rgb):
        return ((rgb - target) ** 2).reshape(n_scenes, -1).mean(-1)

    img_loss = mse(out["rgb_map"])
    loss = img_loss
    aux = {"psnr": mse2psnr(img_loss), "img_loss": img_loss}
    if "rgb0" in out:
        img_loss0 = mse(out["rgb0"])
        loss = loss + img_loss0
        aux["img_loss0"] = img_loss0
        aux["psnr0"] = mse2psnr(img_loss0)
    aux["loss"] = loss
    return loss.sum(), aux


def make_stacked_train_step(
    model: NeRFModel,
    rs: RenderSettings,
    lrate: float,
    lrate_decay: int,
    n_scenes: int,
):
    """The train step of S scenes as one stacked step (nerf_tpu's
    ``jax.vmap(make_train_step_fn(...))``, parallel/multi_scene.py:44-64):
    ``step(state, rays_o, rays_d, near, far, target, generators=None,
    overrides=None, hwf=None, lr=None) -> aux`` with the state's nets stacked
    (StackedNeRFMLP), every input [S, R, ...] and ``aux`` of [S] values
    (detached). The draws come from ``overrides`` ([S, R, ...] each) when
    given, else from ``generators``, one a scene, each drawing its scene's
    streams as ``make_train_step`` would alone (``draw_overrides``): one
    small draw a scene, since a scene's generator is its own. The learning
    rate is ``lr`` (a 0-dim device tensor: train/graph.py's input) when
    given, else the schedule's at ``state.step``. The rays of
    every scene then go through one render (render_rays on [S*R] rays, the
    stacked K1/K4 on each level), one loss and one backward. With rs.ndc,
    ``hwf`` [S, 3] holds each scene's (H, W, focal), applied per ray in f32
    (nerf_tpu's hwf_operand, step.py:149-181).

    One Adam over the stacked leaves: Adam is elementwise, so with the
    shared step count and this schedule (the first scene's config's) it
    makes the S updates that S Adams, one a scene, would make."""
    schedule = lr_schedule(lrate, lrate_decay)

    def step(state: TrainState, rays_o, rays_d, near, far, target, generators=None,
             overrides=None, hwf=None, lr=None) -> Dict[str, torch.Tensor]:
        S, R = rays_o.shape[:2]
        if S != n_scenes:
            raise ValueError(f"expected {n_scenes} scenes, got rays of {S}")
        if overrides is None and generators is not None:
            draws = [draw_overrides(g, R, rs) for g in generators]
            overrides = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
        overrides = {k: v.flatten(0, 1) for k, v in (overrides or {}).items()}
        rays_o, rays_d, near, far, target = (
            t.flatten(0, 1) for t in (rays_o, rays_d, near, far, target))
        viewdirs = None
        if rs.use_viewdirs:
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if rs.ndc:
            if hwf is None:
                raise ValueError("rs.ndc=True requires hwf [S, 3], each scene's (H, W, focal)")
            per_ray = hwf.to(rays_o.dtype).repeat_interleave(R, 0)
            rays_o, rays_d = ndc_rays(per_ray[:, 0], per_ray[:, 1], per_ray[:, 2], 1.0,
                                      rays_o, rays_d)
        set_lr(state.optimizer, schedule(state.step) if lr is None else lr)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = stacked_loss_fn(state.nets, model, rs, S, rays_o, rays_d, viewdirs, near,
                                    far, target, overrides=overrides)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in aux.items()}

    return step
