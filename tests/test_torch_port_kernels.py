"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (marker ``cuda``) and skip elsewhere. The file
imports neither JAX nor nerf_tpu, so the card's machine, which has no JAX,
runs it without the repository's conftest (``-s`` shows the errors the K2
and K3 tests measure):

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


# K2 and K3, the points-in pair: x [N, 3] from memory, a view direction per
# point (spr = 1, the renderer's mode at S % 8 != 0) or per ray (spr = S).
# (R, S, spr): ragged tails and full tiles in both modes.
POINTS_CASES = ((5, 13, 1), (33, 24, 24), (64, 191, 1), (16, 64, 64))
# K3's f32 weight grads: as K4's, plus one effect K4's cases here do not
# meet: a relu input within ~1e-7 of zero, which the kernel's and the plain
# f32 forward put on opposite sides, switches one point's cotangent chain,
# and the first trunk layers' grads are small, cancelling sums (ROADMAP C).
# Measured up to 1.0e-4 on an H100 (W1, W=256, R=64, S=191; PERF.md).
K3_F32_TOL = 5e-4
# dx and dv, per-tensor relative L2: per point, so no sum over points
# averages such a switch away, and dx multiplies the top octave's d_e by
# 2^9. Measured on an H100: f32 up to 9.0e-4 (dx, W=256, R=64, S=191), bf16
# up to 7.0e-3 (dx, W=256, R=16, S=64); bounds ~2x and ~3x that.
INPUT_GRAD_F32_TOL = 2e-3
INPUT_GRAD_BF16_TOL = 2e-2


def _points(seed, R, S, spr, dev):
    """(x [R*S, 3], v [R*S/spr, 3]) on rays, as the renderer makes them."""
    ro, rd, vd, z = _rays(seed, R, S, dev)
    x = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(R * S, 3)
    return x, (vd if spr > 1 else vd.repeat_interleave(S, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
def test_fused_points_kernel_matches_plain_version(cuda_device, width, dtype, tol):
    mlp = NeRFMLP(MLPConfig(width=width), seed=width + 2, device=cuda_device)
    kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
    for R, S, spr in POINTS_CASES:
        x, v = _points(R * S + 2, R, S, spr, cuda_device)
        before = fused_mlp.fused_points.launches
        out = fused_mlp.fused_points(kp, x, v, spr)
        torch.cuda.synchronize()
        assert fused_mlp.fused_points.launches == before + 1
        ref = fused_mlp.fused_points_reference(kp, x, v, spr)
        assert out.shape == (R * S, 4)
        err = float((out - ref).abs().max())
        print(f"K2 W={width} {dtype} R={R} S={S} spr={spr}: max abs {err:.3e}")  # with -s
        assert err <= tol, (R, S, err)
        spread = (ref - ref.mean(dim=0, keepdim=True)).abs().mean(dim=0).min()
        assert tol < float(spread)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype,tol,in_tol", [(torch.float32, K3_F32_TOL, INPUT_GRAD_F32_TOL),
                                              (torch.bfloat16, K4_BF16_TOL, INPUT_GRAD_BF16_TOL)])
@pytest.mark.parametrize("input_grads", [True, False])
def test_fused_points_bwd_kernel_matches_plain_version(cuda_device, width, dtype, tol, in_tol,
                                                       input_grads):
    mlp = NeRFMLP(MLPConfig(width=width), seed=width + 3, device=cuda_device)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
    for R, S, spr in POINTS_CASES:
        x, v = _points(R * S + 3, R, S, spr, cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(R)
        g = (0.5 + torch.rand(R * S, 4, device=cuda_device, generator=gen)) * 1e-4
        before = fused_mlp.fused_points_bwd.launches
        got = fused_mlp.fused_points_bwd(kp, x, v, g, spr, input_grads)
        again = fused_mlp.fused_points_bwd(kp, x, v, g, spr, input_grads)
        torch.cuda.synchronize()
        assert fused_mlp.fused_points_bwd.launches == before + 2
        ref = fused_mlp.fused_points_bwd_reference(kp, x, v, g, spr, input_grads)
        errs = {name: _rel_l2(got[0][name], ref[0][name]) for name in fused_mlp.KP_NAMES}
        if input_grads:
            errs.update(dx=_rel_l2(got[1], ref[1]), dv=_rel_l2(got[2], ref[2]))
        worst = max((e, n) for n, e in errs.items() if n not in ("dx", "dv"))
        print(f"K3 W={width} {dtype} R={R} S={S} spr={spr} input_grads={input_grads}: "
              f"worst leaf {worst[1]} {worst[0]:.3e}"
              + "".join(f", {n} {errs[n]:.3e}" for n in ("dx", "dv") if n in errs))  # with -s
        for name in fused_mlp.KP_NAMES:
            assert got[0][name].shape == kp[name].shape, name
            assert torch.equal(got[0][name], again[0][name]), name  # no atomics
            assert errs[name] <= tol, (R, S, name, errs[name])
        if not input_grads:
            assert got[1] is None and got[2] is None
            continue
        for k, name in ((1, "dx"), (2, "dv")):
            assert got[k].shape == ref[k].shape, name
            assert torch.equal(got[k], again[k]), name
            assert errs[name] <= in_tol, (R, S, name, errs[name])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_points_kernel_on_ray_points_matches_raygen_kernel(cuda_device, dtype):
    """At S % 8 == 0, K2 on x = o + d·z (PyTorch's multiply, then add: no
    FMA, as K1 computes it) is K1 with its planes as rows: the same points,
    tiles and arithmetic (nerf_tpu's test_raygen_matches_pts_path)."""
    mlp = NeRFMLP(MLPConfig(width=256), seed=11, device=cuda_device)
    kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
    ro, rd, vd, z = _rays(11, 37, 64, cuda_device)
    x = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    planes = fused_mlp.fused_rays_planes(kp, ro, rd, vd, z)
    rows = fused_mlp.fused_points(kp, x, vd, 64)
    assert torch.equal(rows, planes.reshape(4, -1).T)


@pytest.mark.cuda
def test_fused_query_differentiates_through_k3(cuda_device):
    cfg = MLPConfig(width=256)
    mlp = NeRFMLP(cfg, seed=6, device=cuda_device)
    x, _ = _points(6, 40, 63, 1, cuda_device)
    pts = x.reshape(40, 63, 3).requires_grad_(True)
    vd = _rays(6, 40, 63, cuda_device)[2].requires_grad_(True)
    k2, k3 = fused_mlp.fused_points.launches, fused_mlp.fused_points_bwd.launches
    out = fused_mlp.fused_query(mlp, cfg, PE_P, PE_V, pts, vd)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert fused_mlp.fused_points.launches == k2 + 1
    assert fused_mlp.fused_points_bwd.launches == k3 + 1
    grads = [p.grad for p in mlp.parameters()] + [pts.grad, vd.grad]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
