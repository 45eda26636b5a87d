"""The model-parallel NeRF MLP of the DP×TP train step (parallel/mesh.py).

Counterpart of nerf_tpu's ``param_sharding(mesh, params, True)``
(nerf_tpu/parallel/mesh.py:49-65) under its jitted step: every weight and
bias whose out dimension divides by the ``'model'`` axis is split along it,
every other leaf is replicated, and XLA inserts the collectives. Here a
rank of a model group holds its rows of each sharded ``nn.Linear`` (the
port keeps weights as [out, in], so the out dimension is dim 0 of weight
and bias alike) and the whole of each replicated one, and the collectives
are written out:

- a sharded layer is the local ``dense`` on its rows, then an all-gather
  of its out columns over the model group, in model-index order, so what
  follows it (relu, the skip concat, the next layer's input, the heads) is
  the whole tensor and is computed alike on every model rank;
- backward, the gather hands each rank its own columns of the gradient
  (``_GatherColumns``), with no communication: that gradient is the same
  on every model rank, because its input gradient was made whole first;
- for that, the input of a sharded layer passes ``_SumOverModel``
  (identity forward; backward, a sum over the model group): the local
  product's input gradient is this rank's share, summed over the ranks it
  is the whole one. A replicated layer's input gradient is whole already.

``torch.distributed.nn.functional.all_gather`` would not do for the
gather: its backward sums over the ranks, which, on gradients already whole,
makes each sharded gradient n_model times too large. Only ``all_gather``
and ``all_reduce`` are used (gloo has no reduce-scatter of a card's
tensors).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
from torch import nn

from nerf_tpu_torch.models.nerf_mlp import NeRFMLP, dense, run_layers


def sharded_params(net: nn.Module, n_model: int) -> Dict[str, bool]:
    """By parameter name, whether nerf_tpu shards the leaf over ``n_model``
    model ranks: its layer's out dimension divides by n_model (weight and
    bias alike)."""
    out = {}
    for name, module in net.named_modules():
        if isinstance(module, nn.Linear):
            for leaf in ("weight", "bias"):
                out[f"{name}.{leaf}"] = n_model > 1 and module.out_features % n_model == 0
    return out


class _GatherColumns(torch.autograd.Function):
    """Forward: the model ranks' column blocks [..., k] gathered to [..., n k]
    in model-index order. Backward: this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, y, group, index: int, n: int):
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        ctx.block = (index * y.shape[-1], (index + 1) * y.shape[-1])
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.block
        return grad[..., lo:hi], None, None, None


class _SumOverModel(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient summed over the model
    group (each rank's product on its rows gives its share of the input
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _rows(t: torch.Tensor, index: int, n: int) -> torch.Tensor:
    return t.chunk(n, 0)[index]


class ShardedNeRFMLP(nn.Module):
    """A ``NeRFMLP`` held over a mesh's model group: this rank's rows of
    every layer ``sharded_params`` shards, the whole of every other, under
    the reference's names (so ``gather_state`` gives the whole net's state
    dict). ``apply_mlp`` keeps ``NeRFMLP.apply_mlp``'s signature, order and
    bf16 rounding, so ``render/network.py::query_raw``'s plain branch takes
    it unchanged; ``plain_calls`` counts its calls, as ``NeRFMLP``'s does
    its own."""

    plain_calls = 0

    def __init__(self, net: NeRFMLP, mesh):
        super().__init__()
        self.cfg = net.cfg
        self.group, self.index, self.n = mesh.model_group, mesh.model_index, mesh.n_model
        self.sharded = sharded_params(net, self.n)

        def shard(name: str, lin: nn.Linear) -> nn.Linear:
            split = self.sharded[f"{name}.weight"]
            out = lin.out_features // self.n if split else lin.out_features
            new = nn.Linear(lin.in_features, out, device=lin.weight.device, dtype=lin.weight.dtype)
            with torch.no_grad():
                for leaf in ("weight", "bias"):
                    getattr(new, leaf).copy_(self.local(f"{name}.{leaf}", getattr(lin, leaf)))
            new.model_sharded = split
            return new

        for child, module in net.named_children():
            if isinstance(module, nn.ModuleList):
                setattr(self, child, nn.ModuleList(
                    [shard(f"{child}.{i}", lin) for i, lin in enumerate(module)]))
            else:
                setattr(self, child, shard(child, module))

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor of parameter ``name`` (or of
        one of its Adam moments): its rows where the leaf is sharded."""
        return _rows(whole, self.index, self.n) if self.sharded[name] else whole

    def apply_mlp(
        self,
        x_emb: torch.Tensor,
        views_emb=None,
        compute_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        ShardedNeRFMLP.plain_calls += 1

        def layer(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
            if not lin.model_sharded:
                return dense(lin, x, compute_dtype)
            y = dense(lin, _SumOverModel.apply(x, self.group), compute_dtype)
            return _GatherColumns.apply(y, self.group, self.index, self.n)

        return run_layers(self, x_emb, views_emb, layer)

    forward = apply_mlp


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole tensor from the model ranks' rows (dim 0), in model-index
    order: every rank of the model group calls it."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
    dist.all_gather(parts, t, group=mesh.model_group)
    return torch.cat(parts, 0)
