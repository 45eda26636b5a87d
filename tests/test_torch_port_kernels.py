"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (marker ``cuda``) and skip elsewhere. The file
imports neither JAX nor nerf_tpu, so the card's machine, which has no JAX,
runs it without the repository's conftest (``-s`` shows the errors the K2,
K3, K5 and K6 tests measure):

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


# K5 and K6, the fused-render pair: rays -> maps with the compositing in
# K5, and K6's compositing backward feeding K4's phases. (R, S): chip_smoke
# phase 14's shapes, full and ragged ray groups (two rays a CTA at S = 64
# and 192) and the one-ray group with a masked tail (S = 200).
RENDER_CASES = ((1024, 64), (1000, 64), (1024, 192), (1000, 192), (1024, 200), (1000, 200))


def _render_inputs(seed, R, S, dev):
    """_rays plus sigma noise of std 0.5, which leaves some rays partly
    empty (a negative sigma on the last sample)."""
    rays = _rays(seed, R, S, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return rays + [torch.randn(R, S, device=dev, generator=gen) * 0.5]


def _maps_err(got, ref):
    """The largest |difference| over rgb, disp (where finite), acc and w."""
    errs = []
    for a, b in zip(got[:4], ref[:4]):
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        f = torch.isfinite(b)
        errs.append(float((a[f] - b[f]).abs().max()))
    return max(errs)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("white", [False, True])
def test_fused_render_kernel_matches_plain_version(cuda_device, width, dtype, tol, white):
    from nerf_tpu_torch.experimental import fused_render

    mlp = NeRFMLP(MLPConfig(width=width), seed=width + 4, device=cuda_device)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
    for R, S in RENDER_CASES:
        ro, rd, vd, z, noise = _render_inputs(R + S, R, S, cuda_device)
        before = fused_render.fused_render_fwd.launches
        out = fused_render.fused_render_fwd(kp, ro, rd, vd, z, noise, white, keep_raw=True)
        torch.cuda.synchronize()
        assert fused_render.fused_render_fwd.launches == before + 1
        with torch.no_grad():
            ref = fused_render.fused_render_reference(kp, ro, rd, vd, z, noise, white)
        err = _maps_err(out, ref)
        # the bound sees the input-dependent part of the colours
        spread = float((ref.rgb - ref.rgb.mean(0)).abs().mean(0).min())
        print(f"K5 W={width} {dtype} white={white} R={R} S={S}: max abs {err:.3e}, "
              f"rgb spread {spread:.3e}")  # with -s
        assert err <= tol and tol < spread, (R, S, err, spread)
        # the residual raw is K1's planes bit for bit: one tile body
        assert torch.equal(out.raw, fused_mlp.fused_rays_planes(kp, ro, rd, vd, z))
        served = fused_render.fused_render_fwd(kp, ro, rd, vd, z, noise, white)
        assert served.raw is None and all(torch.equal(a, b) for a, b in zip(served[:4], out[:4]))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, K4_F32_TOL), (torch.bfloat16, K4_BF16_TOL)])
def test_fused_render_bwd_kernel_matches_plain_version(cuda_device, width, dtype, tol):
    from nerf_tpu_torch.experimental import fused_render

    mlp = NeRFMLP(MLPConfig(width=width), seed=width + 5, device=cuda_device)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
    for i, (R, S) in enumerate(RENDER_CASES):
        white = i % 2 == 0
        ro, rd, vd, z, noise = _render_inputs(R + S + 1, R, S, cuda_device)
        raw = fused_render.fused_render_fwd(kp, ro, rd, vd, z, noise, white, keep_raw=True).raw
        gen = torch.Generator(device=cuda_device).manual_seed(R + S)
        # the cotangents of an image loss and of its companions: one-signed
        g = [(0.5 + torch.rand(*s, device=cuda_device, generator=gen)) * 1e-4
             for s in ((R, 3), (R,), (R,), (R, S))]
        before = (fused_render.fused_render_bwd.launches, fused_mlp.fused_rays_planes_bwd.launches)
        got = fused_render.fused_render_bwd(kp, ro, rd, vd, z, noise, raw, *g, white)
        again = fused_render.fused_render_bwd(kp, ro, rd, vd, z, noise, raw, *g, white)
        torch.cuda.synchronize()
        # two K6 calls, and K4's counter untouched: its phases run inside K6
        assert (fused_render.fused_render_bwd.launches,
                fused_mlp.fused_rays_planes_bwd.launches) == (before[0] + 2, before[1])
        with torch.no_grad():
            ref = fused_render.fused_render_bwd_reference(kp, ro, rd, vd, z, noise, raw, *g,
                                                          white)
            # K6's first half alone: the cotangent of raw, f32 on both sides,
            # exp/log ulps and the prefix sums' order apart (measured up to
            # 7.4e-7 on an H100, PERF.md)
            planes = fused_render._launch_composite_bwd(raw, rd, z, noise, *g, white)
            want = fused_render.composite_bwd_reference(raw, rd, z, noise, *g, white)
        planes_err = _rel_l2(planes, want)
        assert planes_err <= 1e-5, (R, S, planes_err)
        errs = {name: _rel_l2(got[name], ref[name]) for name in fused_mlp.KP_NAMES}
        worst = max((e, n) for n, e in errs.items())
        print(f"K6 W={width} {dtype} white={white} R={R} S={S}: worst leaf {worst[1]} "
              f"{worst[0]:.3e}, raw cotangent {planes_err:.3e}")  # with -s
        for name in fused_mlp.KP_NAMES:
            assert got[name].shape == kp[name].shape, name
            assert torch.equal(got[name], again[name]), name  # no atomics: bit-identical
            assert errs[name] <= tol, (R, S, name, errs[name])


@pytest.mark.cuda
def test_fused_render_level_differentiates_through_k6(cuda_device):
    from nerf_tpu_torch.experimental import fused_render

    cfg = MLPConfig(width=256)
    mlp = NeRFMLP(cfg, seed=8, device=cuda_device)
    ro, rd, vd, z, noise = _render_inputs(8, 40, 64, cuda_device)
    counters = (fused_render.fused_render_fwd, fused_render.fused_render_bwd,
                fused_mlp.fused_rays_planes, fused_mlp.fused_rays_planes_bwd,
                fused_mlp.fused_points, fused_mlp.fused_points_bwd)
    before = [c.launches for c in counters]
    out = fused_render.fused_render_level(mlp, cfg, PE_P, PE_V, ro, rd, vd, z, noise, True)
    (out.rgb.square().sum() + out.acc.sum() + out.weights.sum()).backward()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0, 0, 0]
    grads = [p.grad for p in mlp.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)


# K7, the probes of K1's tile (nerf_tpu_torch/tools/probe_overlap.py): each
# body against its plain version, relative to the output's largest
# magnitude: two bf16 ulps there (both sides round the same operands; an
# f32 sum in another order that crosses a rounding edge moves an output by
# an ulp; measured up to 6.1e-3 of the largest magnitude on an H100,
# PERF.md), below the output's input-dependent spread; two launches
# bit-identical.
PROBE_TOL_REL = 2.0 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["matmul_only", "bias_relu", "interleaved", "embed_trunk",
                                  "embed_trunk_il", "embed_notrig", "embed_poly", "full",
                                  "products"])
def test_probe_kernel_matches_plain_version(cuda_device, body):
    from nerf_tpu_torch.tools import probe_overlap as P

    for npts in (3 * 192, 64 * 192):  # a ragged last tile; 96 full tiles
        inp = P.make_inputs(npts=npts, seed=npts).to(cuda_device)
        before = P.probe.launches
        out = P.probe(body, inp)
        again = P.probe(body, inp)
        torch.cuda.synchronize()
        assert P.probe.launches == before + 2
        ref = P.probe_reference(body, inp)
        live = ref[:, :4] if body == "full" else ref
        tol = PROBE_TOL_REL * float(live.abs().max())
        assert out.shape == ref.shape == (npts, 256)
        assert torch.equal(out, again)
        assert float((out - ref).abs().max()) <= tol
        if body == "full":
            assert not bool(out[:, 4:].any())
        assert tol < float((live - live.mean(0)).abs().mean())
