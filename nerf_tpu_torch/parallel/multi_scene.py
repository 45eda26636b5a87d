"""Multi-scene training: S scenes of one model shape as one stacked step.

Counterpart of nerf_tpu/parallel/multi_scene.py, which trains S scenes as
one ``jax.vmap`` of the single-scene step, so that on the TPU K1 and K4 run
once a level for all S scenes. Here the S nets are one ``StackedNeRFMLP``
a level (every parameter [S, ...]; render/network.py), the step is
``train/step.py::make_stacked_train_step``: the S scenes' rays go through
one render whose levels each launch the stacked K1 and K4 once for every
scene (ops/fused_mlp.py), and one Adam updates the stacked leaves. Scene
k's result is what training it alone gives, scene by scene.

Over the ranks of a process group (``make_sharded_multi_scene_step``; one
card a rank through ``parallel/distributed.launch``) each rank owns S/n
contiguous scenes and trains them with no communication between ranks.

Scene k's random streams are its own: its nets start from seed
``scene_seed(seed, k)``, its sampler and its step draw from generators
seeded one and two above it, as ``train()`` seeds them for one scene. They
depend on k alone, not on S, so scene k's init and draws are the same alone
or in a pack of any size.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from nerf_tpu_torch.data.scene import Scene
from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.geom.rays import get_rays
from nerf_tpu_torch.models.factory import init_nets
from nerf_tpu_torch.render.network import NeRFModel, StackedNeRFMLP
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.train.step import TrainState, init_train_state, make_stacked_train_step

_MOMENTS = ("exp_avg", "exp_avg_sq")


def scene_seed(seed: int, k: int) -> int:
    """Scene k's seed: its nets start from it, its sampler and step draw
    from generators seeded at +1 and +2 (``train()``'s one-scene seeds),
    so scene k trains as ``cli.train --seed scene_seed(seed, k)`` would."""
    return seed + 3 * k


def stack_states(states: Sequence[TrainState]) -> TrainState:
    """S one-scene train states (one model shape, one step count, one
    device) as one stacked state: each level's nets a StackedNeRFMLP, one
    Adam over its leaves holding every scene's moments stacked."""
    steps = {st.step for st in states}
    if len(steps) != 1:
        raise ValueError(f"the scenes' states must share their step; got {sorted(steps)}")
    lr = states[0].optimizer.param_groups[0]["lr"]
    nets = {level: StackedNeRFMLP.from_nets([st.nets[level] for st in states])
            for level in states[0].nets}
    out = init_train_state(nets, lr, start_step=states[0].step)
    for level, net in nets.items():
        per_scene = [dict(st.nets[level].named_parameters()) for st in states]
        for name, p in net.named_parameters():
            held = [st.optimizer.state.get(params[name], {}) for st, params in zip(states, per_scene)]
            if not any(held):
                continue
            if not all(held):
                raise ValueError(f"{level}.{name}: Adam state in some scenes only")
            out.optimizer.state[p] = {
                "step": held[0]["step"].clone(),
                **{k: torch.stack([h[k] for h in held]).detach().clone() for k in _MOMENTS}}
    return out


def unstack_states(state: TrainState, n: int) -> List[TrainState]:
    """The stacked state's S one-scene states (copies), scene order."""
    out = []
    lr = state.optimizer.param_groups[0]["lr"]
    for s in range(n):
        nets = {level: net.net(s) for level, net in state.nets.items()}
        st = init_train_state(nets, lr, start_step=state.step)
        for level, net in state.nets.items():
            mine = dict(nets[level].named_parameters())
            for name, p in net.named_parameters():
                held = state.optimizer.state.get(p)
                if held:
                    st.optimizer.state[mine[name]] = {
                        "step": held["step"].clone(),
                        **{k: held[k][s].clone() for k in _MOMENTS}}
        out.append(st)
    return out


def init_multi_scene_state(model: NeRFModel, seeds: Sequence[int], lrate: float,
                           device: DeviceLike = None) -> TrainState:
    """The stacked state of len(seeds) scenes, scene k's nets from seeds[k]
    (``init_nets``)."""
    dev = resolve_device(device)
    return stack_states([init_train_state(init_nets(model, seed, dev), lrate) for seed in seeds])


# nerf_tpu's name for the stacked step of S scenes (its vmapped step):
# make_multi_scene_step(model, rs, lrate, lrate_decay, n_scenes)
make_multi_scene_step = make_stacked_train_step


def shard_scene_axis(mesh, x):
    """This rank's contiguous share of a leading scene axis (a tensor, or a
    list with an entry a scene): S/n scenes of the mesh's n ranks."""
    return x[mesh.shard_slice(len(x))]


def make_sharded_multi_scene_step(mesh, model: NeRFModel, rs: RenderSettings, lrate: float,
                                  lrate_decay: int, n_scenes: int):
    """The stacked step with the scene axis over the mesh's ranks: each rank
    steps its own S/n scenes (its state holds only theirs; its inputs are
    their rows, ``shard_scene_axis``), and no rank waits on another, as
    the scenes share nothing (nerf_tpu shards the vmapped step's scene axis
    over 'data', multi_scene.py:67-95)."""
    if n_scenes % mesh.size:
        raise ValueError(f"{n_scenes} scenes do not divide over {mesh.size} ranks")
    return make_multi_scene_step(model, rs, lrate, lrate_decay, n_scenes // mesh.size)


def one_scene_sample(n_train: int, generator: torch.Generator, *, n_rand: int, crop):
    """One scene's policy-(b) draws, in ``ImageRaySampler.next_batch``'s
    order on its generator: the train view (its position among the n_train),
    then the pixels of the crop (row0, col0, rows, cols), without
    replacement, or with it when the crop has fewer than n_rand. Returns
    (view position, pixel rows, pixel columns), on the generator's device."""
    dev = generator.device
    pick = torch.randint(n_train, (1,), generator=generator, device=dev)[0]
    row0, col0, rows, cols = crop
    n = rows * cols
    if n_rand > n:
        flat = torch.randint(n, (n_rand,), generator=generator, device=dev)
    else:
        flat = torch.randperm(n, generator=generator, device=dev)[:n_rand]
    return pick, row0 + flat // cols, col0 + flat % cols


class StackedImageSampler:
    """S homogeneous scenes' policy-(b) samplers (``ImageRaySampler``) as one
    sampling pass. Each scene's draws come from its own generator, in its
    own ImageRaySampler's order (``one_scene_sample``); the rays of every
    train view are made once, up front, by ``get_rays`` (as ImageRaySampler
    makes them a step at a time), so that a step is the draws and one
    gather of all S scenes' rays and colours, and its batches equal S
    ImageRaySamplers' built with the same generators, bit for bit. The
    batch comes as [S, n_rand, 3] tensors; the precrop schedule is the
    first config's. Raises ValueError unless every scene has the same H, W
    and number of train views (nerf_tpu's homogeneity check). Holds the
    train views' images and ray directions on the device: 24 bytes a
    pixel. A fused chunk (train/graph.py's ChunkRunner; nerf_tpu's sweep
    scans its stacked sample, tools/multiscene_sweep.py:112-126) calls
    ``next_batch`` for its k steps, which draw on the generators (on the
    device) as k calls would; its crop is fixed, so a chunk never crosses
    ``precrop_iters``."""

    def __init__(self, scenes: Sequence[Scene], n_rand: int,
                 generators: Sequence[torch.Generator], precrop_iters: int = 0,
                 precrop_frac: float = 0.5, device: DeviceLike = None):
        s0 = scenes[0]
        for s in scenes[1:]:
            if (s.H, s.W) != (s0.H, s0.W) or len(s.i_train) != len(s0.i_train):
                raise ValueError("StackedImageSampler needs homogeneous scenes (one H, W and "
                                 "number of train views)")
        if len(generators) != len(scenes):
            raise ValueError(f"{len(scenes)} scenes need as many generators, got {len(generators)}")
        dev = self.device = resolve_device(device)
        self.H, self.W, self.n_rand = s0.H, s0.W, n_rand
        self.n_train = len(s0.i_train)
        self.precrop_iters = precrop_iters
        self.generators = list(generators)
        train = [np.asarray(s.i_train) for s in scenes]
        self.images = torch.stack([torch.as_tensor(np.asarray(s.images, np.float32)[t], device=dev)
                                   for s, t in zip(scenes, train)])  # [S, n_train, H, W, 3]
        poses = [torch.as_tensor(np.asarray(s.poses, np.float32)[t], device=dev)
                 for s, t in zip(scenes, train)]
        self.origins = torch.stack([p[:, :3, -1] for p in poses])  # [S, n_train, 3]
        self.rays_d = torch.stack([
            torch.stack([get_rays(self.H, self.W, s.K, p[:3, :4])[1] for p in ps])
            for s, ps in zip(scenes, poses)])  # [S, n_train, H, W, 3]
        dH = int(self.H // 2 * precrop_frac)
        dW = int(self.W // 2 * precrop_frac)
        self.crop = (self.H // 2 - dH, self.W // 2 - dW, 2 * dH, 2 * dW)
        self.full = (0, 0, self.H, self.W)

    def next_batch(self, step: int):
        """-> (rays_o, rays_d, target), each [S, n_rand, 3]."""
        crop = self.crop if step < self.precrop_iters else self.full
        draws = [one_scene_sample(self.n_train, g, n_rand=self.n_rand, crop=crop)
                 for g in self.generators]
        pick, r, c = (torch.stack(t) for t in zip(*draws))  # [S], [S, n_rand] x 2
        scene = torch.arange(len(draws), device=self.device)[:, None]
        view = pick[:, None]
        rays_d = self.rays_d[scene, view, r, c]
        rays_o = self.origins[scene, view].expand(rays_d.shape)
        return rays_o, rays_d, self.images[scene, view, r, c]

    # --- the fused chunk (ImageRaySampler's interface, data/rays_dataset.py) ---

    def scan_supported(self) -> bool:
        return True

    def max_chunk(self) -> int:
        return 1 << 30  # no epoch state; the caller keeps a chunk's crop fixed

    def advance(self, k: int) -> None:
        """Nothing to commit: the chunk's draws moved the generators."""
