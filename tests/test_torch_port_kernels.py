"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (marker ``cuda``) and skip elsewhere. The file
imports neither JAX nor nerf_tpu, so the card's machine, which has no JAX,
runs it without the repository's conftest:

    python -m pytest tests/test_torch_port_kernels.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import fused_mlp

PE_P, PE_V = PosEncConfig(10), PosEncConfig(4)
F32_TOL = 1e-4  # summation order and sincosf vs torch.sin ulps only
# nerf_tpu's bf16 forward bound (0.25, tests/test_fused_mlp.py:186-194)
# tightened to 5x the largest max abs measured on an H100 (4.1e-4, PERF.md),
# and checked to lie below the raw's input-dependent part (the mean
# |raw - its channel mean|), so a kernel that lost that part fails.
BF16_TOL = 2e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _rays(seed, R, S, dev):
    rng = np.random.default_rng(seed)
    ro = (rng.standard_normal((R, 3)) * 0.5).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (R, S)).astype(np.float32), -1)
    return [torch.from_numpy(a).to(dev) for a in (ro, rd, vd, z)]


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
def test_fused_mlp_kernel_matches_plain_version(cuda_device, width, dtype, tol):
    mlp = NeRFMLP(MLPConfig(width=width), seed=width, device=cuda_device)
    kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
    for R, S in ((5, 16), (33, 24), (64, 192)):  # ragged tails and full tiles
        args = _rays(R * S, R, S, cuda_device)
        before = fused_mlp.fused_rays_planes.launches
        out = fused_mlp.fused_rays_planes(kp, *args)
        torch.cuda.synchronize()
        assert fused_mlp.fused_rays_planes.launches == before + 1
        ref = fused_mlp.fused_rays_planes_reference(kp, *args)
        assert out.shape == (4, R, S)
        assert float((out - ref).abs().max()) <= tol
        spread = (ref - ref.mean(dim=(1, 2), keepdim=True)).abs().mean(dim=(1, 2)).min()
        assert tol < float(spread)  # the bound sees the input-dependent part


# K4 against its plain version: per-leaf relative L2 of the weight grads,
# for a cotangent of one sign per channel, like an image loss's (a random
# one makes grads that nearly cancel, whose relative error is noise). f32:
# the sums over points run in another order only. bf16: both sides round
# the same operands, but a cotangent whose f32 sum lands on the other side
# of a bf16 rounding edge rounds to the other neighbour. These grads sum
# only 80 to 12,288 points, so one such flip weighs more than at the main
# path's shapes (chip_smoke.py holds those to 1e-3): measured up to 2.5e-3
# here on an H100 (W1, W=256, R=33, S=24; PERF.md), so 1e-2, far inside
# nerf_tpu's 0.05 (tests/test_fused_mlp.py:175-183).
K4_F32_TOL = 1e-4
K4_BF16_TOL = 1e-2


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, K4_F32_TOL), (torch.bfloat16, K4_BF16_TOL)])
def test_fused_mlp_bwd_kernel_matches_plain_version(cuda_device, width, dtype, tol):
    mlp = NeRFMLP(MLPConfig(width=width), seed=width + 1, device=cuda_device)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
    for R, S in ((5, 16), (33, 24), (64, 192)):  # ragged tails and full tiles
        args = _rays(R * S + 1, R, S, cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(R)
        g = (0.5 + torch.rand(4, R, S, device=cuda_device, generator=gen)) * 1e-4
        before = fused_mlp.fused_rays_planes_bwd.launches
        got = fused_mlp.fused_rays_planes_bwd(kp, *args, g)
        again = fused_mlp.fused_rays_planes_bwd(kp, *args, g)
        torch.cuda.synchronize()
        assert fused_mlp.fused_rays_planes_bwd.launches == before + 2
        ref = fused_mlp.fused_rays_planes_bwd_reference(kp, *args, g)
        assert set(got) == set(ref) == set(fused_mlp.KP_NAMES)
        for name in fused_mlp.KP_NAMES:
            assert got[name].shape == kp[name].shape, name
            assert torch.equal(got[name], again[name]), name  # no atomics: bit-identical
            assert _rel_l2(got[name], ref[name]) <= tol, (name, _rel_l2(got[name], ref[name]))


@pytest.mark.cuda
def test_fused_query_differentiates_through_k4(cuda_device):
    cfg = MLPConfig(width=256)
    mlp = NeRFMLP(cfg, seed=5, device=cuda_device)
    args = _rays(7, 40, 64, cuda_device)
    k1, k4 = fused_mlp.fused_rays_planes.launches, fused_mlp.fused_rays_planes_bwd.launches
    out = fused_mlp.fused_query_rays_planes(mlp, cfg, PE_P, PE_V, *args)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert fused_mlp.fused_rays_planes.launches == k1 + 1
    assert fused_mlp.fused_rays_planes_bwd.launches == k4 + 1
    grads = [p.grad for p in mlp.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
