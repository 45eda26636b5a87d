"""Data-parallel and DP×TP training over the ranks of a process group.

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

The mesh is nerf_tpu's ``('data', 'model')``: ``n_data * n_model`` ranks,
rank r at data index ``r // n_model`` and model index ``r % n_model``
(nerf_tpu's ``reshape(n_data, n_model)`` of its devices). A rank's **data
group** holds the ranks of its model index (one a data shard: the
gradients' mean runs over it), its **model group** the ranks of its data
index (the same rays: the model-parallel net's gathers run over it).
``make_sharded_train_step(shard_model_axis=True)`` with ``n_model > 1`` is
nerf_tpu's DP×TP step (ROADMAP A.8b): the nets' layers split over the
model group as nerf_tpu's ``param_sharding`` splits them
(``shard_state``; parallel/tensor_parallel.py), the plain MLP only (the
kernels take whole nets, as nerf_tpu runs only its jnp path there), step by
step (nerf_tpu exposes no body of it to its fused scan). It is reached
from this API alone, as in nerf_tpu: ``train()`` and the CLI build the
data-only mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.distributed as dist

from nerf_tpu_torch.device import DeviceLike
from nerf_tpu_torch.parallel import distributed, tensor_parallel
from nerf_tpu_torch.parallel.tensor_parallel import ShardedNeRFMLP
from nerf_tpu_torch.train.step import (
    TrainState, draw_overrides, init_train_state, make_train_step,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process group as nerf_tpu's ``('data', 'model')`` mesh, seen from
    this rank: ``size`` ranks along ``'data'`` (the data axis's size, which
    the samplers and ``train()`` shard rays over), ``n_model`` along
    ``'model'``, this process's ``rank`` in ``group`` (every rank) and its
    ``device``; ``data_group`` (``group`` when n_model is 1) and
    ``model_group`` (None then) as the module docstring says."""

    group: Any
    size: int
    rank: int
    device: torch.device
    n_model: int = 1
    data_group: Any = None
    model_group: Any = None

    def __post_init__(self):
        if self.data_group is None:
            object.__setattr__(self, "data_group", self.group)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def shard_slice(self, n_total: int) -> slice:
        """This rank's contiguous rows of a length-n_total batch axis: its
        data index's share (the model ranks of one data index hold the same
        rows)."""
        return distributed.shard_slice(n_total, self.data_index, self.size)

    def __str__(self) -> str:
        return (f"Mesh(data={self.size}, model={self.n_model}, rank={self.rank}, "
                f"device={self.device})")


def make_mesh(n_data: int, n_model: int = 1, device: DeviceLike = None) -> Mesh:
    """The mesh of ``n_data * n_model`` ranks, seen from this rank, which
    runs on ``distributed.rank_device(device)``. Raises unless the process
    group has exactly that many ranks. With n_model > 1 every rank makes
    every data group, then every model group, in the same order
    (``dist.new_group`` is collective); with n_model 1 the data group is the
    whole group, as it was before the model axis."""
    if distributed.world_size() != n_data * n_model:
        raise ValueError(f"a mesh of {n_data} x {n_model} ranks needs a process group of "
                         f"{n_data * n_model}; this one has {distributed.world_size()}")
    group = dist.group.WORLD
    rank = dist.get_rank(group)
    dev = distributed.rank_device(device)
    if n_model == 1:
        return Mesh(group=group, size=n_data, rank=rank, device=dev)
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    return Mesh(group=group, size=n_data, rank=rank, device=dev, n_model=n_model,
                data_group=data_groups[rank % n_model], model_group=model_groups[rank // n_model])


def param_sharding(mesh: Mesh, net: torch.nn.Module,
                   shard_model_axis: bool = False) -> Dict[str, bool]:
    """By parameter name, whether the leaf is split over the model axis
    (nerf_tpu/parallel/mesh.py:49-65): with ``shard_model_axis`` and
    n_model > 1, every weight and bias whose layer's out dimension divides
    by n_model; nothing otherwise."""
    return tensor_parallel.sharded_params(net, mesh.n_model if shard_model_axis else 1)


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


def shard_state(mesh: Mesh, state: TrainState) -> TrainState:
    """This rank's state of the DP×TP step from the whole state every rank
    holds (``place_state``'s, rank 0's): each net as a ``ShardedNeRFMLP``
    and an Adam over their parameters whose step count and moments, where
    the whole state has them, are the same parts of the whole ones (Adam is
    elementwise, so the sharded Adam makes the whole one's updates, a part
    each). With n_model 1 the state is returned as it is."""
    if mesh.n_model == 1:
        return state
    nets = {level: ShardedNeRFMLP(net, mesh) for level, net in state.nets.items()}
    lr = float(state.optimizer.param_groups[0]["lr"])
    out = init_train_state(nets, lr, start_step=state.step)
    for level, net in nets.items():
        whole = dict(state.nets[level].named_parameters())
        for name, p in net.named_parameters():
            held = state.optimizer.state.get(whole[name])
            if held:
                out.optimizer.state[p] = {
                    k: v.clone() if k == "step" else net.local(name, v).clone()
                    for k, v in held.items()}
    return out


def gather_state(mesh: Mesh, state: TrainState) -> dict:
    """The whole nets' state from a rank's state, on every rank: ``{"step",
    "params": {level: {name: tensor}}, "moments": {level: {name: (exp_avg,
    exp_avg_sq)}}}`` in the reference layout (a ``params[level]`` loads into
    a ``NeRFMLP`` with ``strict=True``), a sharded leaf gathered over the
    model group. Every rank of the mesh calls it."""
    out = {"step": state.step, "params": {}, "moments": {}}
    for level, net in state.nets.items():
        sharded = getattr(net, "sharded", {})
        out["params"][level], out["moments"][level] = {}, {}
        for name, p in net.named_parameters():
            held = state.optimizer.state.get(p, {})
            ts = [p.detach()] + [held[k] for k in ("exp_avg", "exp_avg_sq") if k in held]
            if sharded.get(name):
                ts = [tensor_parallel.gather_rows(t, mesh) for t in ts]
            out["params"][level][name] = ts[0].clone()
            if len(ts) == 3:
                out["moments"][level][name] = (ts[1].clone(), ts[2].clone())
    return out


def make_sharded_train_step(mesh: Mesh, model, rs, lrate: float, lrate_decay: int, hwf=None,
                            shard_model_axis: bool = False):
    """The train step over the mesh, with the port's signature:
    ``step(state, rays_o, rays_d, near, far, target, generator=None,
    overrides=None, lr=None) -> aux``, where the rays are this rank's rows
    (its data index's: the samplers' ``mesh`` batches, ``shard_batch``) and
    ``overrides``, when given, are the whole batch's. The draws are made for
    the whole batch from ``generator`` (the same seed on every rank), then
    this rank's rows are taken; ``lr`` is ``make_train_step``'s (a 0-dim
    device tensor, else the schedule's at ``state.step``); the per-rank step
    averages the gradients and the loss terms over the data group, so
    ``aux`` is the whole batch's on every rank.

    With ``shard_model_axis`` and n_model > 1 this is nerf_tpu's DP×TP step
    (``make_sharded_train_step(..., shard_model_axis=True)``): ``state``
    is ``shard_state``'s; the sharded gradients are a rank's own and the
    replicated ones equal on its model group, so the data group's mean is
    the whole step's. It runs the plain MLP: a model with its kernels on
    (``fused``, ``fused_render``) raises a ValueError, since the kernels
    take whole nets. With n_model 1 the flag changes nothing (nerf_tpu
    replicates every leaf there)."""
    tp = shard_model_axis and mesh.n_model > 1
    if tp and (model.fused or model.fused_render):
        raise ValueError("the DP×TP step (shard_model_axis over n_model > 1) runs the plain "
                         "MLP, as nerf_tpu's runs only its jnp path: the kernels take whole "
                         "nets; build the model with fused=False and fused_render=False")
    step = make_train_step(model, rs, lrate, lrate_decay, hwf=hwf, group=mesh.data_group)

    def sharded_step(state: TrainState, rays_o, rays_d, near, far, target, generator=None,
                     overrides=None, lr=None):
        if tp and not all(isinstance(net, ShardedNeRFMLP) for net in state.nets.values()):
            raise ValueError("the DP×TP step takes shard_state(mesh, state)'s state")
        n_global = rays_o.shape[0] * mesh.size
        if overrides is None:
            overrides = {} if generator is None else draw_overrides(generator, n_global, rs)
        rows = mesh.shard_slice(n_global)
        overrides = {k: v[rows] for k, v in overrides.items()}
        return step(state, rays_o, rays_d, near, far, target, overrides=overrides, lr=lr)

    return sharded_step
