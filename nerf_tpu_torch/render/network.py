"""Network query: embed sampled points (+viewdirs) and evaluate the MLP.

Counterpart of nerf_tpu/render/network.py. ``query_raw`` is the points-in
path, which the renderer takes when its fused raygen branch does not apply
(S not a multiple of 8). Two paths with the same semantics:
- plain: posenc + ``NeRFMLP.apply_mlp`` in PyTorch;
- fused (``model.fused``, viewdirs, a supported MLP):
  ``ops/fused_mlp.py::fused_query``, which launches K2 forward and K3
  backward on a CUDA tensor (their plain versions on a CPU one).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
