"""Network query: embed sampled points (+viewdirs) and evaluate the MLP.

Counterpart of nerf_tpu/render/network.py. ``query_raw`` is the points-in
path, which the renderer takes when its fused raygen branch does not apply
(S not a multiple of 8). Two paths with the same semantics:
- plain: posenc + ``NeRFMLP.apply_mlp`` in PyTorch;
- fused (``model.fused``, viewdirs, a supported MLP):
  ``ops/fused_mlp.py::fused_query``, which launches K2 forward and K3
  backward on a CUDA tensor (their plain versions on a CPU one).

``StackedNeRFMLP`` holds S nets of one configuration as one module, every
parameter with a leading scene axis: nerf_tpu's stacked pytree of
multi-scene training (parallel/multi_scene.py), which the renderer sends
through the stacked K1/K4 (``ops/fused_mlp.py::fused_query_rays_planes_stacked``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.models.embedding import PosEncConfig, posenc
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
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


class StackedLinear(nn.Module):
    """S ``nn.Linear`` layers of one shape: weight [S, out, in], bias [S, out]."""

    def __init__(self, n_scenes: int, in_features: int, out_features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_scenes, out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(n_scenes, out_features, device=device))


class StackedNeRFMLP(nn.Module):
    """S ``NeRFMLP`` nets of one ``MLPConfig`` as one module, each parameter
    stacked on a leading scene axis under nerf-pytorch's names
    (``pts_linears.i.weight`` [S, out, in], ``views_linears.0``, ...): scene
    s's slice of the state_dict is a NeRFMLP's and loads into one with
    strict=True. The renderer runs it through the stacked K1/K4 only
    (render/renderer.py)."""

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

    def scene_state_dict(self, s: int) -> Dict[str, torch.Tensor]:
        """Scene s's parameters (detached views) as a NeRFMLP state_dict."""
        return {name: p.detach()[s] for name, p in self.named_parameters()}

    def net(self, s: int) -> NeRFMLP:
        """Scene s's net, a NeRFMLP holding a copy of its parameters."""
        p0 = next(self.parameters())
        mlp = NeRFMLP(self.cfg, device=p0.device)
        mlp.load_state_dict(self.scene_state_dict(s), strict=True)
        return mlp
