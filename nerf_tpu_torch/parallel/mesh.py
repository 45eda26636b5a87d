"""Data-parallel training over the ranks of a process group.

Counterpart of nerf_tpu/parallel/mesh.py. nerf_tpu shards every per-ray
tensor over a ``'data'`` mesh axis and runs its step under ``shard_map``:
the Pallas kernel per shard, then an explicit ``pmean`` of the gradients.
Here each rank of a torch.distributed group is one shard: it runs the
existing step on its own ``N_rand / n`` rays (the same kernels), then
all-reduces the gradients one level at a time, and every rank runs the
same Adam update. The random draws are made for the whole batch on every
rank, from one seed, and sliced, as nerf_tpu draws them globally
(mesh.py:90-92), so n ranks train as one process does, up to the order of
f32 sums. The sharded step takes the same ``lr`` tensor as the one-process
step, so ``train()``'s fused loop (train/graph.py) runs it as k steps of
one CUDA graph on each rank, NCCL's all-reduces inside (nerf_tpu's scan of
its shard_map step, ROADMAP A.3b).

nerf_tpu's DP×TP path (``shard_model_axis=True``, parameters sharded over
a ``'model'`` axis) is not ported (ROADMAP A.8b).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from nerf_tpu_torch.device import DeviceLike
from nerf_tpu_torch.parallel import distributed
from nerf_tpu_torch.train.step import TrainState, draw_overrides, make_train_step


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process group as nerf_tpu's ``'data'`` axis: its ``size`` ranks,
    this process's ``rank`` and the rank's ``device``."""

    group: Any
    size: int
    rank: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard_slice(self, n_total: int) -> slice:
        """This rank's contiguous rows of a length-n_total batch axis."""
        return distributed.shard_slice(n_total, self.rank, self.size)

    def __str__(self) -> str:
        return f"Mesh(data={self.size}, rank={self.rank}, device={self.device})"


def make_mesh(n_data: int, device: DeviceLike = None) -> Mesh:
    """The group of the ``n_data`` ranks, seen from this rank, which runs on
    ``distributed.rank_device(device)``. Raises unless the process group
    has exactly ``n_data`` ranks."""
    if distributed.world_size() != n_data:
        raise ValueError(f"a mesh of {n_data} ranks needs a process group of {n_data}; this "
                         f"one has {distributed.world_size()}")
    group = dist.group.WORLD
    return Mesh(group=group, size=n_data, rank=dist.get_rank(group),
                device=distributed.rank_device(device))


def shard_batch(mesh: Mesh, *tensors):
    """Each tensor's rows of this rank (the leading axis split over ranks)."""
    out = tuple(t[mesh.shard_slice(t.shape[0])] for t in tensors)
    return out if len(out) > 1 else out[0]


def place_state(mesh: Mesh, state: TrainState) -> TrainState:
    """Make every rank's state rank 0's: its parameters and Adam moments are
    broadcast (a fresh state and a resumed one alike). Every rank must have
    the same nets and the same moments present."""
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for level in ("coarse", "fine"):
            if level not in state.nets:
                continue
            for p in state.nets[level].parameters():
                dist.broadcast(p.data, src, group=mesh.group)
                for key in ("exp_avg", "exp_avg_sq"):
                    moment = state.optimizer.state.get(p, {}).get(key)
                    if moment is not None:
                        dist.broadcast(moment, src, group=mesh.group)
    return state


def make_sharded_train_step(mesh: Mesh, model, rs, lrate: float, lrate_decay: int, hwf=None):
    """The train step over the mesh, with the port's signature:
    ``step(state, rays_o, rays_d, near, far, target, generator=None,
    overrides=None, lr=None) -> aux``, where the rays are this rank's rows
    (the samplers' ``mesh`` batches) and ``overrides``, when given, are the
    whole batch's. The draws are made for the whole batch from
    ``generator`` (the same seed on every rank), then this rank's rows are
    taken; ``lr`` is ``make_train_step``'s (a 0-dim device tensor, else
    the schedule's at ``state.step``); the per-rank step all-reduces the
    gradients and the loss terms, so ``aux`` is the whole batch's on every
    rank."""
    step = make_train_step(model, rs, lrate, lrate_decay, hwf=hwf, group=mesh.group)

    def sharded_step(state: TrainState, rays_o, rays_d, near, far, target, generator=None,
                     overrides=None, lr=None):
        n_global = rays_o.shape[0] * mesh.size
        if overrides is None:
            overrides = draw_overrides(generator, n_global, rs)
        rows = mesh.shard_slice(n_global)
        overrides = {k: v[rows] for k, v in overrides.items()}
        return step(state, rays_o, rays_d, near, far, target, overrides=overrides, lr=lr)

    return sharded_step
