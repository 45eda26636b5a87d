"""Volume-rendering compositor: raw network outputs -> per-ray maps.

Semantics of the reference ``raw2outputs`` (run_nerf.py:262-305):
- ``dists = diff(z_vals)`` with 1e10 appended, scaled by ``‖rays_d‖``;
- ``rgb = sigmoid(raw[...,:3])``; optional Gaussian noise on sigma before
  the ReLU; ``alpha = 1 - exp(-relu(sigma)·dist)``;
- transmittance = exclusive cumprod of ``(1 - alpha + 1e-10)``;
- ``depth = Σ w·z``; ``disp = 1/max(1e-10, depth/Σw)``; ``acc = Σw``;
- ``white_bkgd: rgb += (1 - acc)``.

``raw2outputs_planes(matmul_scan=True)`` is ``nerf_tpu``'s variant that its
renderer takes on every bf16 run of the planes branch
(nerf_tpu/render/renderer.py:159): the transmittance as
``exp(log(1 - alpha + 1e-10) @ U)``, U the strictly upper triangle of ones,
a product in IEEE f32 (``Precision.HIGHEST`` there). It differs from the
exact cumprod by ~1e-6 relative on the weights; the f32 path keeps the
cumprod.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class RayOutputs:
    """Per-ray composited maps."""

    rgb: torch.Tensor  # [N_rays, 3]
    disp: torch.Tensor  # [N_rays]
    acc: torch.Tensor  # [N_rays]
    weights: torch.Tensor  # [N_rays, N_samples]
    depth: torch.Tensor  # [N_rays]


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of an input with no zero. Its
    backward is torch's own for such an input (cumprod_backward in
    torch/csrc/autograd/FunctionsManual.cpp: the reversed cumsum of
    output * grad, over the input), without torch's test for a zero,
    ``(input == 0).any()`` read on the host: a sync a call, which no CUDA
    graph may capture (train/graph.py). The compositor's input,
    (1 - alpha) + 1e-10 after a leading 1, is never 0."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, -1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        if x.shape[-1] <= 1:
            return grad
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod along the last axis, shifted right with a leading 1 (ref
    run_nerf.py:295); ``x`` holds no zero (``_Cumprod``)."""
    ones = torch.ones_like(x[..., :1])
    return _Cumprod.apply(torch.cat([ones, x], -1))[..., :-1]


_UPPER: Dict[Tuple[int, str], torch.Tensor] = {}


def strict_upper_ones(S: int, device) -> torch.Tensor:
    """U [S, S] float32 with U[j, i] = 1 iff j < i, so (x @ U)_i = sum_{j<i}
    x_j (nerf_tpu/ops/compositing.py::strict_upper_ones), made once per (S,
    device) and kept: the first call, eager, makes it, and a CUDA graph's
    capture (train/graph.py, after a warm-up step) only reads it."""
    key = (S, str(device))
    U = _UPPER.get(key)
    if U is None:
        U = _UPPER[key] = torch.ones(S, S, dtype=torch.float32, device=device).triu_(1)
    return U


@contextlib.contextmanager
def _ieee_f32_matmul():
    """cuBLAS's float32 products without TF32 inside: the process's setting
    (``torch.set_float32_matmul_precision``) is "highest" for the block and
    restored after it; nothing is read on the device."""
    saved = torch.get_float32_matmul_precision()
    if saved != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if saved != "highest":
            torch.set_float32_matmul_precision(saved)


class _ExclusiveSum(torch.autograd.Function):
    """``x @ U`` over the last axis (U = ``strict_upper_ones``), forward and
    backward (``grad @ U.T``) each one product in IEEE f32, whatever the
    process allows for float32 products: nerf_tpu runs it at
    ``Precision.HIGHEST``, and a TF32 product would round log-transmittances
    to 10 mantissa bits."""

    @staticmethod
    def forward(ctx, x):
        U = strict_upper_ones(x.shape[-1], x.device)
        ctx.U = U
        with _ieee_f32_matmul():
            return x @ U

    @staticmethod
    def backward(ctx, grad):
        with _ieee_f32_matmul():
            return grad @ ctx.U.T


def sigma_noise(like: torch.Tensor, raw_noise_std: float,
                generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
    """The pre-activation density noise of ``like``'s shape (ref
    run_nerf.py:283-291), one draw from ``generator``; None without noise."""
    if raw_noise_std <= 0.0:
        return None
    if generator is None:
        raise ValueError("raw_noise_std>0 requires a generator or explicit noise")
    n = torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)
    return n * raw_noise_std


def _sigma_with_noise(sigma, noise, raw_noise_std, generator):
    if noise is None:
        noise = sigma_noise(sigma, raw_noise_std, generator)
    return sigma if noise is None else sigma + noise


def _one_minus_alpha(alpha):
    """(1 - alpha) + 1e-10, written so that no compiler can fold the adds into
    (1 + 1e-10) - alpha and lose the floor where alpha == 1
    (nerf_tpu/ops/compositing.py:70-76)."""
    return torch.clamp(1.0 - alpha, min=0.0) + 1e-10


def _dists(z_vals, rays_d):
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    return dists * torch.linalg.norm(rays_d, dim=-1)[..., None]


def _maps(weights, rgb_map, z_vals, white_bkgd):
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RayOutputs(rgb=rgb_map, disp=disp_map, acc=acc_map, weights=weights, depth=depth_map)


def raw2outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> RayOutputs:
    """raw [N_rays, N_samples, 4], z_vals [N_rays, N_samples], rays_d
    [N_rays, 3] -> maps. ``noise`` overrides the sigma-noise draw."""
    dists = _dists(z_vals, rays_d)
    rgb = torch.sigmoid(raw[..., :3])
    sigma = _sigma_with_noise(raw[..., 3], noise, raw_noise_std, generator)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    weights = alpha * exclusive_cumprod(_one_minus_alpha(alpha))
    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    return _maps(weights, rgb_map, z_vals, white_bkgd)


def raw2outputs_planes(
    raw4: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    matmul_scan: bool = False,
) -> RayOutputs:
    """raw2outputs on channel-plane input raw4 [4, N_rays, N_samples], the
    layout the fused kernel writes (ops/fused_mlp.py). With
    ``matmul_scan`` the transmittance is nerf_tpu's
    ``exp(log(1 - alpha + 1e-10) @ U)`` (``_ExclusiveSum``) instead of the
    exact exclusive cumprod; the dists are the same either way (nerf_tpu's
    shifted form has 0/±1 coefficients, so it is exact)."""
    dists = _dists(z_vals, rays_d)
    rgb = torch.sigmoid(raw4[:3])  # [3, N_rays, N_samples]
    sigma = _sigma_with_noise(raw4[3], noise, raw_noise_std, generator)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    one_m_alpha = _one_minus_alpha(alpha)
    if matmul_scan:
        weights = alpha * torch.exp(_ExclusiveSum.apply(torch.log(one_m_alpha)))
    else:
        weights = alpha * exclusive_cumprod(one_m_alpha)
    rgb_map = torch.sum(weights[None] * rgb, -1).T  # [N_rays, 3]
    return _maps(weights, rgb_map, z_vals, white_bkgd)
