"""Network query: embed sampled points (+viewdirs) and evaluate the MLP.

Counterpart of nerf_tpu/render/network.py. ``query_raw`` is the points-in
path, which the renderer takes when its fused raygen branch does not apply
(S not a multiple of 8). Two paths with the same semantics:
- plain: posenc + ``NeRFMLP.apply_mlp`` in PyTorch;
- fused (``model.fused``, viewdirs, an MLP within nerf_tpu's guard,
  ``fused_mlp.supports``): ``ops/fused_mlp.py::fused_query``, which
  launches K2 forward and K3 backward on a CUDA tensor (K2w and K3w of the
  wide family, ops/fused_mlp_wide.py, at widths and octaves the W <= 256
  tile is not built for), their plain versions on a CPU one.

``StackedNeRFMLP`` holds S nets of one configuration as one module, every
parameter with a leading scene axis: nerf_tpu's stacked pytree of
multi-scene training (parallel/multi_scene.py). The renderer sends it
through the stacked form of the branch one net would take: the stacked
K5/K6 (``experimental/fused_render.py::fused_render_level_stacked``), the
stacked K1/K4 (``ops/fused_mlp.py::fused_query_rays_planes_stacked``), or
``query_raw_stacked``: the stacked K2/K3 (``fused_mlp.fused_query_stacked``)
or, where the kernels do not apply, the stacked plain MLP
(``StackedNeRFMLP.apply_mlp``, batched products over the scene axis).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.models.embedding import PosEncConfig, posenc
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP, round_to
from nerf_tpu_torch.ops import fused_mlp


@dataclasses.dataclass(frozen=True)
class NeRFModel:
    """Static description of the full model (embedders + coarse/fine MLP
    configs). The networks themselves are ``NeRFMLP`` modules passed
    separately as ``{"coarse": ..., "fine": ...}``."""

    pe_pts: PosEncConfig
    pe_views: Optional[PosEncConfig]
    coarse: MLPConfig
    fine: Optional[MLPConfig]
    compute_dtype: str = "float32"
    fused: bool = False
    # the single-kernel rays->maps path (experimental/fused_render.py): K5
    # forward with the compositing in the kernel, K6 backward
    fused_render: bool = False

    def mlp_config(self, level: str) -> MLPConfig:
        if level == "fine" and self.fine is not None:
            return self.fine
        return self.coarse

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def query_raw(
    mlp: NeRFMLP,
    model: NeRFModel,
    pts: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
    input_grads: bool = True,
) -> torch.Tensor:
    """Raw (r,g,b,sigma) [R, S, 4] float32 at points [R, S, 3], with unit
    view directions [R, 3] (None without viewdirs). ``input_grads=False``
    when the caller guarantees pts/viewdirs carry no gradient (the renderer
    detaches them): the fused backward then skips its dx/dv branch."""
    R, S, _ = pts.shape
    if (
        model.fused
        and viewdirs is not None
        and fused_mlp.supports(mlp.cfg, model.pe_pts, model.pe_views)
    ):
        return fused_mlp.fused_query(
            mlp, mlp.cfg, model.pe_pts, model.pe_views, pts, viewdirs,
            compute_dtype=model.torch_compute_dtype, input_grads=input_grads,
        )
    x_emb = posenc(pts.reshape(R * S, 3), model.pe_pts)
    v_emb = None
    if viewdirs is not None:
        v_emb = posenc(viewdirs, model.pe_views)  # [R, Cv]
        v_emb = v_emb[:, None, :].expand(R, S, v_emb.shape[-1]).reshape(R * S, -1)
    raw = mlp.apply_mlp(x_emb, v_emb, compute_dtype=model.torch_compute_dtype)
    return raw.reshape(R, S, raw.shape[-1])


def query_raw_stacked(
    mlp: "StackedNeRFMLP",
    model: NeRFModel,
    pts: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
) -> torch.Tensor:
    """``query_raw`` for a stacked net: raw [S, R, N, 4] float32 at points
    [S, R, N, 3], with unit view directions [S, R, 3] (None without
    viewdirs), scene s's through scene s's net. The points and directions
    get no gradient (the renderer detaches them). Fused (``model.fused``,
    viewdirs, an MLP within the kernels' guard, ``fused_mlp.supports``): the
    stacked K2/K3 (K2ws/K3ws at the wide family's configurations); otherwise
    the stacked plain MLP."""
    S, R, N, _ = pts.shape
    if (
        model.fused
        and viewdirs is not None
        and fused_mlp.supports(mlp.cfg, model.pe_pts, model.pe_views)
    ):
        return fused_mlp.fused_query_stacked(
            mlp, mlp.cfg, model.pe_pts, model.pe_views, pts, viewdirs,
            compute_dtype=model.torch_compute_dtype,
        )
    x_emb = posenc(pts.detach().reshape(S, R * N, 3), model.pe_pts)
    v_emb = None
    if viewdirs is not None:
        v_emb = posenc(viewdirs.detach(), model.pe_views)  # [S, R, Cv]
        v_emb = v_emb[:, :, None, :].expand(S, R, N, v_emb.shape[-1]).reshape(S, R * N, -1)
    raw = mlp.apply_mlp(x_emb, v_emb, compute_dtype=model.torch_compute_dtype)
    return raw.reshape(S, R, N, raw.shape[-1])


class StackedLinear(nn.Module):
    """S ``nn.Linear`` layers of one shape: weight [S, out, in], bias [S, out]."""

    def __init__(self, n_scenes: int, in_features: int, out_features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_scenes, out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(n_scenes, out_features, device=device))

    def dense(self, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
        """Scene s's ``x[s] @ w[s].T + b[s]`` for x [S, P, in], one batched
        product, operands in ``compute_dtype`` and sums in float32 (models/
        nerf_mlp.py's ``dense`` over the scene axis)."""
        w = round_to(self.weight, compute_dtype)
        return torch.bmm(round_to(x, compute_dtype), w.mT) + self.bias[:, None, :]


class StackedNeRFMLP(nn.Module):
    """S ``NeRFMLP`` nets of one ``MLPConfig`` as one module, each parameter
    stacked on a leading scene axis under nerf-pytorch's names
    (``pts_linears.i.weight`` [S, out, in], ``views_linears.0``, ...): scene
    s's slice of the state_dict is a NeRFMLP's and loads into one with
    strict=True. The renderer runs it through the stacked kernels of the
    branch one net would take (render/renderer.py), and through
    ``apply_mlp``, the plain forward, only where nerf_tpu runs no kernel
    (``fused_kernels`` off, no viewdirs, an MLP outside
    ``fused_mlp.supports``). ``plain_calls`` counts the plain forward's
    calls: on the card with the kernels on it is never called."""

    plain_calls = 0

    def __init__(self, cfg: MLPConfig, n_scenes: int, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.n_scenes = cfg, n_scenes
        W = cfg.width

        def lin(fan_in, fan_out):
            return StackedLinear(n_scenes, fan_in, fan_out, device=dev)

        trunk, fan_in = [], cfg.input_ch
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

    @classmethod
    def from_nets(cls, nets: Sequence[NeRFMLP]) -> "StackedNeRFMLP":
        """The nets (one configuration, one device) stacked in order."""
        p0 = next(nets[0].parameters())
        out = cls(nets[0].cfg, len(nets), device=p0.device)
        sds = [n.state_dict() for n in nets]
        with torch.no_grad():
            for name, p in out.named_parameters():
                p.copy_(torch.stack([sd[name] for sd in sds]))
        return out

    def apply_mlp(
        self,
        x_emb: torch.Tensor,
        views_emb: Optional[torch.Tensor] = None,
        compute_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """Embedded points [S, P, input_ch] (+ embedded dirs [S, P, Cv]) ->
        raw [S, P, 4] float32 (or [S, P, output_ch] without viewdirs), scene
        s's by scene s's net: ``NeRFMLP.apply_mlp`` with each layer a batched
        product over the scene axis (``StackedLinear.dense``)."""
        StackedNeRFMLP.plain_calls += 1
        cfg = self.cfg
        h = x_emb
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(layer.dense(h, compute_dtype))
            if i in cfg.skips:
                h = torch.cat([x_emb, h], dim=-1)
        if not cfg.use_viewdirs:
            return self.output_linear.dense(h, compute_dtype)
        if views_emb is None:
            raise ValueError("use_viewdirs=True requires views_emb")
        alpha = self.alpha_linear.dense(h, compute_dtype)
        feature = self.feature_linear.dense(h, compute_dtype)
        h = torch.relu(
            self.views_linears[0].dense(torch.cat([feature, views_emb], -1), compute_dtype)
        )
        rgb = self.rgb_linear.dense(h, compute_dtype)
        return torch.cat([rgb, alpha], dim=-1)

    forward = apply_mlp

    def scene_state_dict(self, s: int) -> Dict[str, torch.Tensor]:
        """Scene s's parameters (detached views) as a NeRFMLP state_dict."""
        return {name: p.detach()[s] for name, p in self.named_parameters()}

    def net(self, s: int) -> NeRFMLP:
        """Scene s's net, a NeRFMLP holding a copy of its parameters."""
        p0 = next(self.parameters())
        mlp = NeRFMLP(self.cfg, device=p0.device)
        mlp.load_state_dict(self.scene_state_dict(s), strict=True)
        return mlp
