"""Model factory: NeRFConfig -> NeRFModel + the initial networks.

Counterpart of nerf_tpu/models/factory.py, the model-building half of the
reference ``create_nerf`` (run_nerf.py:178-207); the optimizer lives in
train/step.py.
"""

from __future__ import annotations

from typing import Dict

from nerf_tpu_torch.config import NeRFConfig
from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.render.network import NeRFModel


def make_model(cfg: NeRFConfig) -> NeRFModel:
    if cfg.i_embed == -1:  # identity embedding (ref run_nerf_helpers.py:49-50)
        pe_pts = PosEncConfig.identity()
    else:
        pe_pts = PosEncConfig(num_freqs=cfg.multires)
    pe_views = None
    input_ch_views = 0
    if cfg.use_viewdirs:
        pe_views = (
            PosEncConfig.identity()
            if cfg.i_embed == -1
            else PosEncConfig(num_freqs=cfg.multires_views)
        )
        input_ch_views = pe_views.out_dim
    # output_ch=5 when N_importance>0 mirrors ref run_nerf.py:187 (the 5th
    # channel only exists without viewdirs, and is unused there too)
    output_ch = 5 if cfg.N_importance > 0 else 4

    def mlp_config(depth: int, width: int) -> MLPConfig:
        return MLPConfig(
            depth=depth,
            width=width,
            input_ch=pe_pts.out_dim,
            input_ch_views=input_ch_views,
            output_ch=output_ch,
            use_viewdirs=cfg.use_viewdirs,
        )

    fine = None
    if cfg.N_importance > 0:
        fine = mlp_config(cfg.netdepth_fine, cfg.netwidth_fine)
    return NeRFModel(
        pe_pts=pe_pts,
        pe_views=pe_views,
        coarse=mlp_config(cfg.netdepth, cfg.netwidth),
        fine=fine,
        compute_dtype=cfg.compute_dtype,
        fused=cfg.fused_kernels,
        fused_render=cfg.fused_kernels and cfg.fused_render,
    )


def init_nets(model: NeRFModel, seed: int, device: DeviceLike = None) -> Dict[str, NeRFMLP]:
    """{"coarse", "fine"} networks with random weights from ``seed`` (the
    counterpart of nerf_tpu's init_model_params; the fine net gets the next
    seed). Torch's generator gives other numbers than jax.random, so the two
    packages start from different weights; models/convert.py carries weights
    across."""
    dev = resolve_device(device)
    nets = {"coarse": NeRFMLP(model.coarse, seed=seed, device=dev)}
    if model.fine is not None:
        nets["fine"] = NeRFMLP(model.fine, seed=seed + 1, device=dev)
    return nets
