"""The NeRF MLP as an ``nn.Module`` with nerf-pytorch's parameter names.

Architecture of the reference ``NeRF`` (run_nerf_helpers.py:67-119):

- a depth-8 trunk of Linear(..., W) + ReLU; the embedded input is
  re-concatenated after each layer listed in ``skips`` (input first);
- with viewdirs: ``alpha = alpha_linear(h)``, ``feature = feature_linear(h)``,
  one view layer ``views_linears.0`` over ``cat([feature, dirs_emb])`` + ReLU,
  ``rgb = rgb_linear(.)``, output ``cat([rgb, alpha])``;
- without viewdirs: a single ``output_linear``.

Parameters are registered under the reference's names, so a reference
``.tar`` state_dict loads with ``strict=True``. ``views_linears`` is
registered even without viewdirs, as the reference does (it is unused then).

``compute_dtype=torch.bfloat16`` follows ``nerf_tpu``'s semantics: operands
are rounded to bf16 and the products are summed in float32 with no rounding
of the output. A plain bf16 torch matmul would round its output to bf16, so
the operands are rounded and the matmul runs in float32: each product of two
bf16 values is exact in float32, so only the summation order can differ.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from nerf_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """Static NeRF MLP configuration (ref flags netdepth/netwidth etc.)."""

    depth: int = 8
    width: int = 256
    input_ch: int = 63
    input_ch_views: int = 27
    output_ch: int = 4  # used only when use_viewdirs=False
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True


def round_to(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Round float32 ``x`` to ``compute_dtype`` and back (identity in f32)."""
    if compute_dtype == torch.float32:
        return x
    return x.to(compute_dtype).float()


def dense(lin: nn.Linear, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w.T + b`` with operands in ``compute_dtype``, sums in float32."""
    w = round_to(lin.weight, compute_dtype)
    return round_to(x, compute_dtype) @ w.T + lin.bias


class NeRFMLP(nn.Module):
    """The reference MLP. ``plain_calls`` counts the calls of its plain
    forward (``apply_mlp``): on the card with the fused kernels on, a
    configuration that nerf_tpu runs in its kernels never calls it
    (render/network.py). Weights are initialised from ``seed`` with
    torch.nn.Linear's distribution (uniform +-1/sqrt(fan_in) for weight and
    bias) plus ``sigma_bias`` on the density bias (see
    nerf_tpu/models/nerf_mlp.py init_params for why)."""

    plain_calls = 0

    def __init__(
        self,
        cfg: MLPConfig,
        *,
        seed: int = 0,
        sigma_bias: float = 0.1,
        device: DeviceLike = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        W = cfg.width

        def lin(fan_in, fan_out):
            return nn.Linear(fan_in, fan_out, device=dev, dtype=torch.float32)

        trunk = []
        fan_in = cfg.input_ch
        for i in range(cfg.depth):
            trunk.append(lin(fan_in, W))
            fan_in = W + (cfg.input_ch if i in cfg.skips else 0)
        self.pts_linears = nn.ModuleList(trunk)
        self.views_linears = nn.ModuleList([lin(cfg.input_ch_views + W, W // 2)])
        if cfg.use_viewdirs:
            self.feature_linear = lin(W, W)
            self.alpha_linear = lin(W, 1)
            self.rgb_linear = lin(W // 2, 3)
        else:
            self.output_linear = lin(W, cfg.output_ch)
        self.reset_parameters(seed, sigma_bias)

    @torch.no_grad()
    def reset_parameters(self, seed: int, sigma_bias: float = 0.1) -> None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    u = torch.rand(p.shape, generator=gen, dtype=torch.float32)
                    p.copy_(u * (2 * bound) - bound)
        if self.cfg.use_viewdirs:
            self.alpha_linear.bias += sigma_bias
        else:
            self.output_linear.bias[3] += sigma_bias  # channel 3 is sigma

    def apply_mlp(
        self,
        x_emb: torch.Tensor,
        views_emb: Optional[torch.Tensor] = None,
        compute_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """Embedded points [..., input_ch] (+ embedded dirs) -> raw [..., 4]
        float32 (or [..., output_ch] without viewdirs)."""
        NeRFMLP.plain_calls += 1
        return run_layers(self, x_emb, views_emb,
                          lambda lin, x: dense(lin, x, compute_dtype))

    forward = apply_mlp


def run_layers(
    net: nn.Module,
    x_emb: torch.Tensor,
    views_emb: Optional[torch.Tensor],
    layer: Callable[[nn.Linear, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """The reference MLP's forward over ``net``'s layers, found by their
    reference names, each ``nn.Linear`` applied as ``layer(lin, x)``: the
    trunk with its skip concat ``[x_emb, h]``, then the heads. ``NeRFMLP``
    applies ``dense``; the model-parallel net (parallel/tensor_parallel.py)
    gathers a sharded layer's columns after it."""
    cfg = net.cfg
    h = x_emb
    for i, lin in enumerate(net.pts_linears):
        h = torch.relu(layer(lin, h))
        if i in cfg.skips:
            h = torch.cat([x_emb, h], dim=-1)
    if not cfg.use_viewdirs:
        return layer(net.output_linear, h)
    if views_emb is None:
        raise ValueError("use_viewdirs=True requires views_emb")
    alpha = layer(net.alpha_linear, h)
    feature = layer(net.feature_linear, h)
    h = torch.relu(layer(net.views_linears[0], torch.cat([feature, views_emb], -1)))
    rgb = layer(net.rgb_linear, h)
    return torch.cat([rgb, alpha], dim=-1)
