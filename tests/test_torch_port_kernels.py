"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (marker ``cuda``) and skip elsewhere. The file
imports neither JAX nor nerf_tpu, so the card's machine, which has no JAX,
runs it without the repository's conftest (``-s`` shows the errors the K2,
K3, K5 and K6 tests measure):

    python -m pytest tests/test_torch_port_kernels.py --noconftest -m cuda -q
"""

import functools

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


# (R, S) of K1: ragged tails and full tiles; and the bf16 tile's edges: 1,
# 127 and 129 points, and 33,984 points, more than 132 SMs x 2 tiles of 128
# and not a multiple of 128, so the persistent loop wraps and ends ragged
K1_CASES = {"tiles": ((5, 16), (33, 24), (64, 192)),
            "edges": ((1, 1), (127, 1), (3, 43), (531, 64))}


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("shapes", list(K1_CASES))
def test_fused_mlp_kernel_matches_plain_version(cuda_device, width, dtype, tol, shapes):
    mlp = NeRFMLP(MLPConfig(width=width), seed=width, device=cuda_device)
    kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
    for R, S in K1_CASES[shapes]:
        args = _rays(R * S, R, S, cuda_device)
        before = fused_mlp.fused_rays_planes.launches
        out = fused_mlp.fused_rays_planes(kp, *args)
        again = fused_mlp.fused_rays_planes(kp, *args)
        torch.cuda.synchronize()
        assert fused_mlp.fused_rays_planes.launches == before + 2
        assert torch.equal(out, again)  # two launches bit-identical
        ref = fused_mlp.fused_rays_planes_reference(kp, *args)
        assert out.shape == (4, R, S)
        err = float((out - ref).abs().max())
        print(f"K1 W={width} {dtype} R={R} S={S}: max abs {err:.3e}")  # with -s
        assert err <= tol, (R, S, err)
        if R * S < 2:
            continue  # one point has no spread
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


# the recompute's workspace rows against their plain version, with
# chip_smoke.py's bounds (measured there): each layer on the kernel's own
# inputs within one bf16 ulp of the larger side plus the sums' own
# difference near zero, a small share of them differing; against the whole
# plain chain, whose ulps move on from layer to layer, small shares of rows
# and of mask bits differing
RECOMPUTE_ULP, RECOMPUTE_ULP_ATOL = 2.0 ** -7, 2.0 ** -20
RECOMPUTE_LAYER_SHARE, RECOMPUTE_CHAIN_SHARE, RECOMPUTE_MASK_SHARE = 5e-4, 2e-2, 3e-5


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


# (R, S) of the recompute's card test: 1, 127, 129 and 33,984 points (the
# tile's edges and the persistent grid's wrap) and 301 (a ragged third tile)
RECOMPUTE_SHAPES = ((1, 1), (127, 1), (3, 43), (7, 43), (531, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("mode", ["rays", "points, a direction per point"])
@pytest.mark.parametrize("shape", RECOMPUTE_SHAPES, ids=lambda s: f"{s[0] * s[1]}pts")
def test_bwd_recompute_is_the_forward_tile(cuda_device, width, mode, shape):
    """ROADMAP C.4's gate: the bf16 backward's recompute launch (K4's and
    K3's first), with raw, gives K1's (K2's) raw bit for bit; its mask words
    are its own rows' signs; each layer's rows lie within a bf16 ulp of that
    layer's plain version on the kernel's own inputs, and close to the whole
    plain chain, mask bits included; they are written to the last padded
    point; without raw it writes the same."""
    mlp = NeRFMLP(MLPConfig(width=width), seed=width, device=cuda_device)
    kp = fused_mlp.pack_params(mlp, PE_P, PE_V, torch.bfloat16)
    R, S = shape
    ro, rd, vd, z = _rays(width + 1, R, S, cuda_device)
    x = fused_mlp._ray_points(ro, rd, z)
    if mode == "rays":
        v, spr = vd, S
        got = fused_mlp.bwd_recompute_rays(kp, ro, rd, vd, z, raw=True)
        bare = fused_mlp.bwd_recompute_rays(kp, ro, rd, vd, z)
        fwd = fused_mlp.fused_rays_planes(kp, ro, rd, vd, z).reshape(4, -1).T
    else:
        v, spr = vd.repeat_interleave(S, 0), 1
        got = fused_mlp.bwd_recompute(kp, x, v, spr, raw=True)
        bare = fused_mlp.bwd_recompute(kp, x, v, spr)
        fwd = fused_mlp.fused_points(kp, x, v, spr)
    torch.cuda.synchronize()
    assert _same_bits(got.raw, fwd)
    assert got.masks.shape == (fused_mlp.mask_rows(width), -(-R * S // 128) * 128)
    for i, name in enumerate([f"h{j}" for j in range(8)] + ["hv"]):
        rows = got.rows[name]
        bits = fused_mlp.unpack_mask_bits(got.masks[i * (width // 32) :], rows.shape[0])
        assert torch.equal(bits, (rows > 0).T), name
    assert sorted(bare.rows) == sorted(got.rows) and torch.equal(bare.masks, got.masks)
    assert ("ev" in got.rows) == (spr == 1)
    for name, rows in got.rows.items():
        assert _same_bits(bare.rows[name], rows), name
        assert bool(torch.isfinite(rows).all()), name  # the padded points too
    n = R * S
    lay = fused_mlp.recompute_layers_reference(kp, got.rows, x, v, spr)
    ref = fused_mlp.bwd_recompute_reference(kp, x, v, spr)
    for name, rows in got.rows.items():
        g = rows[:, : lay[name].shape[1]].float()
        d = (g - lay[name]).abs()
        excess = float((d - RECOMPUTE_ULP * torch.maximum(g.abs(), lay[name].abs())).max())
        share = float((d > 0).float().mean())
        chain = (g - ref.rows[name]).abs()
        chain_share = float((chain > 0).float().mean())
        print(f"recompute W={width} {mode} {name}: layer excess over an ulp {excess:.3e} "
              f"share {share:.2e}, chain max abs {float(chain.max()):.3e} "
              f"share {chain_share:.2e}")  # with -s
        assert excess <= RECOMPUTE_ULP_ATOL, (name, excess)
        assert share <= RECOMPUTE_LAYER_SHARE, (name, share)
        assert chain_share <= RECOMPUTE_CHAIN_SHARE, (name, chain_share)
    flips = got.masks[:, :n] ^ ref.masks
    mask_share = sum(int(((flips >> b) & 1).sum()) for b in range(32)) / (32 * flips.numel())
    print(f"recompute W={width} {mode}: mask bits differing from the plain chain {mask_share:.2e}")
    assert mask_share <= RECOMPUTE_MASK_SHARE, mask_share


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("P,spr", [(301, 1), (256, 2)])
def test_stacked_recompute_is_each_scenes_own(cuda_device, width, P, spr):
    """The stacked recompute (SceneWalk: each scene a row of the grid, on its
    own net) writes every scene's workspace rows and mask words bit for bit
    as that scene's own launch does on its padded points, the padded tiles
    included, and the mask words are the rows' signs."""
    S = 3
    kps = [fused_mlp.pack_params(NeRFMLP(MLPConfig(width=width), seed=width + s,
                                         device=cuda_device), PE_P, PE_V, torch.bfloat16)
           for s in range(S)]
    kp = {k: torch.stack([q[k] for q in kps]) for k in kps[0]}
    rng = np.random.default_rng(width + P)
    x = torch.from_numpy(rng.uniform(-1.5, 1.5, (S, P, 3)).astype(np.float32)).to(cuda_device)
    v = rng.standard_normal((S, P // spr, 3)).astype(np.float32)
    v = torch.from_numpy(v / np.linalg.norm(v, axis=-1, keepdims=True)).to(cuda_device)
    got = fused_mlp.bwd_recompute_stacked(kp, x, v, spr)
    P_pad = fused_mlp._pad_points(P, spr)
    assert got.masks.shape == (fused_mlp.mask_rows(width), S * P_pad)
    (xp,), (vp,) = fused_mlp._padded((x,), P_pad), fused_mlp._padded((v,), P_pad // spr)
    for s in range(S):
        one = fused_mlp.bwd_recompute(kps[s], xp[s], vp[s], spr)
        cols = slice(s * P_pad, (s + 1) * P_pad)
        assert sorted(one.rows) == sorted(got.rows)
        for name, rows in one.rows.items():
            assert _same_bits(got.rows[name][:, cols].contiguous(), rows), (s, name)
        assert torch.equal(got.masks[:, cols], one.masks), s
    for i, name in enumerate([f"h{j}" for j in range(8)] + ["hv"]):
        bits = fused_mlp.unpack_mask_bits(got.masks[i * (width // 32) :], got.rows[name].shape[0])
        assert torch.equal(bits, (got.rows[name] > 0).T), name


# the chain's blocks against each block's one product on the kernel's own
# inputs (chain_layers_reference), with chip_smoke.py's bounds (measured
# there): both round the same operands and differ only where an f32 sum in
# another order lands on the other side of a bf16 rounding edge (one ulp of
# the larger side), plus the sums' own difference where a cotangent is
# small beside its block's largest, CHAIN_ULP_ATOL of that; at most
# CHAIN_LAYER_SHARE of a case's elements, all blocks pooled, differ. f32
# results (d_hv, the bias parts, dx, dv) lie within CHAIN_F32_REL (relative
# L2) of theirs.
CHAIN_ULP, CHAIN_ULP_ATOL = 2.0 ** -7, 2.0 ** -20
CHAIN_LAYER_SHARE, CHAIN_F32_REL = 2e-3, 2e-6
# (mode, R, S, spr, input grads): 1, 127, 129 and 33,984 points (the tile's
# edges and the persistent wrap), a direction per ray and per point
CHAIN_CASES = (("rays", 1, 1, 1, False), ("rays", 7, 43, 43, False),
               ("rays", 531, 64, 64, False), ("points", 127, 1, 1, True),
               ("points", 129, 1, 1, False), ("points", 3, 43, 43, True),
               ("points", 531, 64, 1, True), ("points", 531, 64, 64, False))


def _chain_launch(kp, case, dev):
    """(the recompute and chain launch's outputs, x, v, g [N, 4]) of a case."""
    mode, R, S, spr, input_grads = case
    if mode == "rays":
        ro, rd, vd, z = _rays(R * S + 11, R, S, dev)
        gp = (0.5 + torch.rand(4, R, S, device=dev)) * 1e-4
        out = fused_mlp.bwd_chain_rays(kp, ro, rd, vd, z, gp)
        return out, fused_mlp._ray_points(ro, rd, z), vd, gp.reshape(4, -1).T.contiguous()
    x, v = _points(R * S + 11, R, S, spr, dev)
    g = (0.5 + torch.rand(R * S, 4, device=dev)) * 1e-4
    return fused_mlp.bwd_chain(kp, x, v, spr, g, input_grads), x, v, g


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("case", CHAIN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bwd_chain_matches_its_layers(cuda_device, width, case):
    """The chain's gate: the bf16 backward's recompute and chain launches
    (K4's and K3's first two) write every block within a bf16 ulp of its one
    product on the kernel's own inputs, zeros past the points (the workspace
    is NaN before), the f32 d_hv, bias parts and input grads close to
    theirs; two launches bit-identical."""
    mlp = NeRFMLP(MLPConfig(width=width), seed=width + 7, device=cuda_device)
    kp = fused_mlp.pack_params(mlp, PE_P, PE_V, torch.bfloat16)
    torch.manual_seed(width)
    before = fused_mlp.bwd_chain.launches
    (rec, got), x, v, g = _chain_launch(kp, case, cuda_device)
    torch.manual_seed(width)
    (_, again), _, _, _ = _chain_launch(kp, case, cuda_device)
    torch.cuda.synchronize()
    assert fused_mlp.bwd_chain.launches == before + 2
    spr, n = case[3], x.shape[0]
    lay = fused_mlp.chain_layers_reference(kp, got.rows, rec.masks, g, spr,
                                           x if case[4] else None, v)
    differ, total = 0, 0
    for name, rows in got.rows.items():
        assert _same_bits(rows, again.rows[name]), name
        assert bool((rows[:, n:] == 0).all()), name  # the padded points, NaN before
        ref, r = lay.rows[name], rows[:, :n].float()
        d = (r - ref).abs()
        excess = float((d - CHAIN_ULP * torch.maximum(r.abs(), ref.abs())).max())
        scale = float(ref.abs().max())
        differ, total = differ + int((d > 0).sum()), total + d.numel()
        print(f"chain W={width} {case} {name}: excess over an ulp {excess:.3e} "
              f"({excess / max(scale, 1e-30):.2e} of the block's max {scale:.3e}), "
              f"share {float((d > 0).float().mean()):.2e}")  # with -s
        assert scale > 0 and excess <= CHAIN_ULP_ATOL * scale, (name, excess, scale)
    assert differ <= CHAIN_LAYER_SHARE * total, (differ, total)
    f32 = {f"bias.{k}": (t, lay.bias[k]) for k, t in got.bias.items()}
    if spr > 1:
        f32["dhv32"] = (got.dhv32, lay.dhv32)
    if case[4]:
        f32["dx"] = (got.dx, lay.dx)
    if got.dv is not None:
        f32["dv"] = (got.dv, lay.dv)
    assert (got.dv is not None) == (case[4] and spr == 1)
    for name, (t, ref) in f32.items():
        other = again.bias[name[5:]] if name.startswith("bias.") else getattr(again, name)
        assert _same_bits(t, other), name
        assert bool((t[ref.shape[0]:] == 0).all()), name  # the padded points' parts and rows
        err = _rel_l2(t[: ref.shape[0]], ref)
        print(f"chain W={width} {case} {name}: relative L2 {err:.3e}")
        assert err <= CHAIN_F32_REL, (name, err)


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
# (R, S, spr): ragged tails and full tiles in both modes; and the bf16
# tile's edges (K1_CASES) in both modes.
POINTS_CASES = {"tiles": ((5, 13, 1), (33, 24, 24), (64, 191, 1), (16, 64, 64)),
                "edges": ((1, 1, 1), (127, 1, 1), (1, 127, 127), (3, 43, 1), (3, 43, 43),
                          (531, 64, 1), (531, 64, 64))}
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
@pytest.mark.parametrize("shapes", list(POINTS_CASES))
def test_fused_points_kernel_matches_plain_version(cuda_device, width, dtype, tol, shapes):
    mlp = NeRFMLP(MLPConfig(width=width), seed=width + 2, device=cuda_device)
    kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
    for R, S, spr in POINTS_CASES[shapes]:
        x, v = _points(R * S + 2, R, S, spr, cuda_device)
        before = fused_mlp.fused_points.launches
        out = fused_mlp.fused_points(kp, x, v, spr)
        again = fused_mlp.fused_points(kp, x, v, spr)
        torch.cuda.synchronize()
        assert fused_mlp.fused_points.launches == before + 2
        assert torch.equal(out, again)  # two launches bit-identical
        ref = fused_mlp.fused_points_reference(kp, x, v, spr)
        assert out.shape == (R * S, 4)
        err = float((out - ref).abs().max())
        print(f"K2 W={width} {dtype} R={R} S={S} spr={spr}: max abs {err:.3e}")  # with -s
        assert err <= tol, (R, S, err)
        if R < 2:
            continue  # one ray: one view direction, too little spread to bound
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
    for R, S, spr in POINTS_CASES["tiles"]:
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


# The edges of the backward's bf16 phases: (kernel, R, S, spr), "K3+dx"
# with input grads. Phase 3 (TMA + wgmma, 64-point chunks, a 4-stage ring,
# splits fixed by the shapes; csrc/fused_mlp_bwd.cu, hopper_splits):
# - K4 301 x 64: 19,264 points, not a multiple of 128; 302 chunks of 64
#   points in 10 splits of 28 and a last of 22 (W=256), 9 of 31 and a last
#   of 23 (W=128); the per-ray rows (dWve) 320 rays, 5 chunks;
# - K3 150 x 63, a direction per point: dWve over points; 148 chunks in 10
#   splits of 14 and a last of 8 (W=256), 8 of 17 and a last of 12 (W=128);
# - K3 77 x 48, a direction per ray: 58 chunks in 4 splits of 12 and a last
#   of 10 (W=256), 6 of 9 and a last of 4 (W=128); 128 per-ray rows, 2 chunks.
# Phase 1 (relu masks in registers, 16-byte workspace transposes) at the
# training step's shapes (K4 4096 x 64 and 4096 x 192), a part tile (301 x
# 64), the view embedding's rows (spr = 1) and K3's d5 read back for dx.
# Held to K4's bound for these sizes: the worst leaf measured up to 5.8e-4
# on an H100 (this test, with -s).
WGRAD_EDGE_CASES = (("K4", 301, 64, 64), ("K3", 150, 63, 1), ("K3", 77, 48, 48),
                    ("K4", 4096, 64, 64), ("K4", 4096, 192, 192), ("K3+dx", 150, 63, 1),
                    ("K3+dx", 77, 48, 48))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("case", WGRAD_EDGE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bwd_weight_grads_at_phase3_edges(cuda_device, width, case):
    kernel, R, S, spr = case
    mlp = NeRFMLP(MLPConfig(width=width), seed=width + 7, device=cuda_device)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, PE_P, PE_V, torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(R)
    inputs = {}
    if kernel == "K4":
        args = _rays(R * S + 5, R, S, cuda_device)
        g = (0.5 + torch.rand(4, R, S, device=cuda_device, generator=gen)) * 1e-4
        got = fused_mlp.fused_rays_planes_bwd(kp, *args, g)
        again = fused_mlp.fused_rays_planes_bwd(kp, *args, g)
        ref = fused_mlp.fused_rays_planes_bwd_reference(kp, *args, g)
    else:
        dx = kernel == "K3+dx"
        x, v = _points(R * S + 5, R, S, spr, cuda_device)
        g = (0.5 + torch.rand(R * S, 4, device=cuda_device, generator=gen)) * 1e-4
        got, *got_in = fused_mlp.fused_points_bwd(kp, x, v, g, spr, dx)
        again, *again_in = fused_mlp.fused_points_bwd(kp, x, v, g, spr, dx)
        ref, *ref_in = fused_mlp.fused_points_bwd_reference(kp, x, v, g, spr, dx)
        if dx:
            inputs = {name: (a, b, r) for name, a, b, r in zip(("dx", "dv"), got_in, again_in,
                                                                ref_in)}
    torch.cuda.synchronize()
    errs = {name: _rel_l2(got[name], ref[name]) for name in fused_mlp.KP_NAMES}
    worst = max((e, n) for n, e in errs.items())
    in_errs = {name: _rel_l2(a, r) for name, (a, _, r) in inputs.items()}
    print(f"{kernel} W={width} R={R} S={S} spr={spr}: worst leaf {worst[1]} {worst[0]:.3e}"
          + "".join(f", {n} {e:.3e}" for n, e in in_errs.items()))  # with -s
    for name in fused_mlp.KP_NAMES:
        assert got[name].shape == kp[name].shape, name
        assert torch.equal(got[name], again[name]), name  # no atomics: bit-identical
        assert errs[name] <= K4_BF16_TOL, (name, errs[name])
    for name, (a, b, r) in inputs.items():
        assert a.shape == r.shape, name
        assert torch.equal(a, b), name
        assert in_errs[name] <= INPUT_GRAD_BF16_TOL, (name, in_errs[name])


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
# phase 14's shapes: ray groups of 2 rays at S = 64 and 192 (1 and 3 tiles
# in bf16), 16 rays and 25 tiles at S = 200 (in f32, a one-ray group with a
# masked tail), full and ragged (1000 rays: 62.5 groups at S = 200).
RENDER_CASES = ((1024, 64), (1000, 64), (1024, 192), (1000, 192), (1024, 200), (1000, 200))
# and the edges of K5's bf16 geometry (csrc/fused_render.cu): one ray; a
# ragged last group of 2 rays; S = 8 (16 rays in one tile), ragged; more
# groups than SMs (the persistent grid wraps: 512 groups at 1024 x 192, 138
# at 2200 x 200, the last ragged)
K5_GEOMETRY_CASES = ((1, 64), (1001, 192), (999, 8), (2200, 200))


def _render_inputs(seed, R, S, dev):
    """_rays plus sigma noise of std 0.5, which leaves some rays partly
    empty (a negative sigma on the last sample)."""
    rays = _rays(seed, R, S, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return rays + [torch.randn(R, S, device=dev, generator=gen) * 0.5]


def _same_bits(a, b):
    """The same f32 bits: torch.equal, but an empty ray's NaN disp (0/0)
    equals itself."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


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
    for R, S in RENDER_CASES + K5_GEOMETRY_CASES:
        ro, rd, vd, z, noise = _render_inputs(R + S, R, S, cuda_device)
        before = fused_render.fused_render_fwd.launches
        out = fused_render.fused_render_fwd(kp, ro, rd, vd, z, noise, white, keep_raw=True)
        torch.cuda.synchronize()
        assert fused_render.fused_render_fwd.launches == before + 1
        # every sum in a fixed order: two launches bit-identical
        again = fused_render.fused_render_fwd(kp, ro, rd, vd, z, noise, white, keep_raw=True)
        assert all(_same_bits(a, b) for a, b in zip(again, out))
        with torch.no_grad():
            ref = fused_render.fused_render_reference(kp, ro, rd, vd, z, noise, white)
        err = _maps_err(out, ref)
        # the bound sees the input-dependent part of the colours
        spread = float((ref.rgb - ref.rgb.mean(0)).abs().mean(0).min())
        print(f"K5 W={width} {dtype} white={white} R={R} S={S}: max abs {err:.3e}, "
              f"rgb spread {spread:.3e}")  # with -s
        assert err <= tol and (R == 1 or tol < spread), (R, S, err, spread)  # one ray: no spread
        # the residual raw: K1's planes bit for bit, in both dtypes (K5 runs
        # K1's tile body: fwd_tile_f32, and fwd_tile_sm90.cuh in bf16)
        assert torch.equal(out.raw, fused_mlp.fused_rays_planes(kp, ro, rd, vd, z))
        # serving (no raw planes: the bf16 kernel's slab) gives the same maps
        served = fused_render.fused_render_fwd(kp, ro, rd, vd, z, noise, white)
        assert served.raw is None and all(_same_bits(a, b) for a, b in zip(served[:4], out[:4]))


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
            # K6's second half alone: K4's phases on the plain cotangent of raw
            # (no K4 launch counted), against the plain weight grads of it
            half = fused_mlp._launch_bwd(kp, ro, rd, vd, z, want, None)
            half_ref = fused_mlp.fused_rays_planes_bwd_reference(kp, ro, rd, vd, z, want)
        planes_err = _rel_l2(planes, want)
        assert planes_err <= 1e-5, (R, S, planes_err)
        errs = {name: _rel_l2(got[name], ref[name]) for name in fused_mlp.KP_NAMES}
        worst = max((e, n) for n, e in errs.items())
        half_worst = max((_rel_l2(half[n], half_ref[n]), n) for n in fused_mlp.KP_NAMES)
        print(f"K6 W={width} {dtype} white={white} R={R} S={S}: worst leaf {worst[1]} "
              f"{worst[0]:.3e}, raw cotangent {planes_err:.3e}, K4's phases on the plain "
              f"cotangent {half_worst[1]} {half_worst[0]:.3e}")  # with -s
        assert half_worst[0] <= tol, (R, S, half_worst)
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


# K6's compositing pass alone (composite_bwd, a warp per ray on K5's
# compositing scan): the cotangent of raw against its plain version, f32 on
# both sides, exp/log ulps and the sums' order apart (per-tensor relative L2;
# chip_smoke.py's COMPOSITE_F32_TOL). S: a lane's share of the samples is 1
# (S = 1, 31), 2 with empty lanes (33), 2, 6 and 7 (64, 192, 200), all with
# the ray staged in shared memory; 10 (300), in device memory in two blocks.
COMPOSITE_F32_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 31, 33, 64, 192, 200, 300])
def test_composite_bwd_kernel_matches_plain_version(cuda_device, S):
    from nerf_tpu_torch.experimental import fused_render

    for R in (1, 37, 1000):  # one ray; ragged warps of a CTA (4 rays)
        _, rd, _, z = _rays(R + S, R, S, cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(R * S)
        raw = torch.randn(4, R, S, device=cuda_device, generator=gen)
        raw[3, 0] = -4.0  # ray 0 empty: every sigma <= 0, acc 0, `live` false
        g = [(0.5 + torch.rand(*shape, device=cuda_device, generator=gen)) * 1e-4
             for shape in ((R, 3), (R,), (R,), (R, S))]
        for noisy in (False, True):
            noise = torch.randn(R, S, device=cuda_device, generator=gen) * 0.5 if noisy else None
            for white in (False, True):
                before = fused_render.composite_bwd.launches
                got = fused_render.composite_bwd(raw, rd, z, noise, *g, white)
                again = fused_render.composite_bwd(raw, rd, z, noise, *g, white)
                torch.cuda.synchronize()
                assert fused_render.composite_bwd.launches == before + 2
                want = fused_render.composite_bwd_reference(raw, rd, z, noise, *g, white)
                err = _rel_l2(got, want)
                print(f"composite_bwd R={R} S={S} noise={noisy} white={white}: rel L2 "
                      f"{err:.3e}")  # with -s
                assert bool(torch.isfinite(got).all())
                assert err <= COMPOSITE_F32_TOL, (R, S, noisy, white, err)
                # the empty ray: w = 0 and sigma <= 0, so its cotangent is zero
                assert not bool(got[:, 0].any()) and not bool(want[:, 0].any())
                # every sum in a fixed order: two launches bit-identical
                assert torch.equal(got.view(torch.int32), again.view(torch.int32))


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


@pytest.mark.cuda
def test_probe_full_is_k2(cuda_device):
    """K7's full body is K1's tile with K2's input: its channels 0..3 are
    K2's raw on the same blob, points and directions, bit for bit (the gate
    that K7 times the production tile), at a ragged last tile and past the
    SMs' first round of tiles."""
    from nerf_tpu_torch.tools import probe_overlap as P

    for npts in (3 * 192, 256 * 192):
        inp = P.make_inputs(npts=npts, seed=npts + 1).to(cuda_device)
        out = P.probe("full", inp)
        k2 = P.k2_raw(inp)
        torch.cuda.synchronize()
        assert torch.equal(out[:, :4], k2)
        assert not bool(out[:, 4:].any())


# data parallelism on the card: two gloo ranks on one card (the machine may
# have one), each running K1 and K4 on its rows, against one process


@pytest.mark.cuda
def test_two_ranks_on_one_card_step_as_one_process(cuda_device):
    import sys
    from pathlib import Path

    from nerf_tpu_torch.models.factory import init_nets
    from nerf_tpu_torch.parallel import distributed
    from nerf_tpu_torch.render.network import NeRFModel
    from nerf_tpu_torch.render.renderer import RenderSettings
    from nerf_tpu_torch.train.step import init_train_state, make_train_step

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_port_parallel_worker import sharded_step_rank

    cfg = MLPConfig(width=128)
    model = NeRFModel(PE_P, PE_V, cfg, cfg, "bfloat16", fused=True)
    rs = RenderSettings(n_samples=64, n_importance=64, white_bkgd=True)
    lrate, decay, n, steps = 5e-4, 500, 512, 2
    nets = init_nets(model, 11, cuda_device)
    start = {lvl: {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
             for lvl, net in nets.items()}
    rng = np.random.default_rng(12)
    batches = []
    for _ in range(steps):
        ro, rd, _, _ = (t.cpu().numpy() for t in _rays(int(rng.integers(1 << 30)), n, 1, "cpu"))
        batches.append(((ro, rd, np.full(n, 2.0, np.float32), np.full(n, 6.0, np.float32),
                         rng.uniform(0, 1, (n, 3)).astype(np.float32)),
                        {"t_rand": rng.uniform(size=(n, 64)).astype(np.float32),
                         "u": rng.uniform(size=(n, 64)).astype(np.float32)}))
    job = {"model": model, "rs": rs, "params": start, "lrate": lrate, "lrate_decay": decay,
           "batches": batches}
    ranks = distributed.launch(sharded_step_rank, 2, "cuda:0", backend="gloo", args=(job,))
    state = init_train_state(nets, lrate)
    step = make_train_step(model, rs, lrate, decay)
    losses = []
    for batch, overrides in batches:
        aux = step(state, *(torch.from_numpy(a).to(cuda_device) for a in batch),
                   overrides={k: torch.from_numpy(v).to(cuda_device) for k, v in overrides.items()})
        losses.append(float(aux["loss"]))
    assert all(r["launches"] == (2 * steps, 2 * steps) for r in ranks)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    for lvl, net in state.nets.items():
        for name, p in net.named_parameters():
            a, b = (r["state"]["params"][lvl][name] for r in ranks)
            assert torch.equal(a, b), name
            # the bounds of tests/test_torch_port_parallel.py: within 4 lr,
            # the update within 5e-2 relative L2
            want, p0 = p.detach().cpu(), start[lvl][name]
            assert float((a - want).abs().max()) <= 4 * lrate, name
            moved = torch.linalg.norm(want - p0)
            if moved > 0:
                assert float(torch.linalg.norm(a - want) / moved) <= 5e-2, name


# The stacked K1 and K4 of multi-scene training (one launch for S scenes'
# rays, each tile on its own scene's weights): against their plain versions
# (K1's and K4's scene by scene) at this file's K1 and K4 bounds, and
# against S single-scene launches. A scene's points are whole tiles, so each
# tile computes what K1 (K4's recompute and chain) computes for it alone,
# and each scene's weight grads split as K4's at its R rays would: the raw
# and, where no scene is padded (R a multiple of 64), the grads equal S
# single-scene launches bit for bit. A padded scene's (R = 100, padded to
# 128 rays with zero cotangents) sum in other splits, within the bound.
STACKED_CASES = ((3, 64, 16), (2, 100, 24), (3, 128, 64))


def _stacked_inputs(seed, S, R, N, dev):
    rays = [_rays(seed + s, R, N, dev) for s in range(S)]
    return [torch.stack(t) for t in zip(*rays)]


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, F32_TOL, K4_F32_TOL),
                                            (torch.bfloat16, BF16_TOL, K4_BF16_TOL)])
def test_stacked_k1_k4_match_plain_and_single_launches(cuda_device, width, dtype, tol, gtol):
    from nerf_tpu_torch.render.network import StackedNeRFMLP

    for S, R, N in STACKED_CASES:
        nets = [NeRFMLP(MLPConfig(width=width), seed=width + s, device=cuda_device)
                for s in range(S)]
        with torch.no_grad():
            kp = fused_mlp.pack_params(StackedNeRFMLP.from_nets(nets), PE_P, PE_V, dtype)
        args = _stacked_inputs(R * N, S, R, N, cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(R)
        g = (0.5 + torch.rand(4, S, R, N, device=cuda_device, generator=gen)) * 1e-4
        before = (fused_mlp.fused_rays_planes_stacked.launches,
                  fused_mlp.fused_rays_planes_stacked_bwd.launches)
        out = fused_mlp.fused_rays_planes_stacked(kp, *args)
        grads = fused_mlp.fused_rays_planes_stacked_bwd(kp, *args, g)
        torch.cuda.synchronize()
        assert (fused_mlp.fused_rays_planes_stacked.launches,
                fused_mlp.fused_rays_planes_stacked_bwd.launches) == (before[0] + 1,
                                                                       before[1] + 1)
        assert out.shape == (4, S, R, N)
        ref = fused_mlp.fused_rays_planes_stacked_reference(kp, *args)
        err = float((out - ref).abs().max())
        ref_g = fused_mlp.fused_rays_planes_stacked_bwd_reference(kp, *args, g)
        gerr = max(_rel_l2(grads[k][s], ref_g[k][s]) for k in ref_g for s in range(S))
        print(f"stacked W={width} {dtype} S={S} R={R} N={N}: K1 max abs {err:.3e}, "
              f"K4 worst leaf {gerr:.3e}")  # with -s
        assert err <= tol and gerr <= gtol, (S, R, N, err, gerr)
        for s in range(S):
            kp_s = {k: v[s].contiguous() for k, v in kp.items()}
            one = [t[s] for t in args]
            assert _same_bits(out[:, s], fused_mlp.fused_rays_planes(kp_s, *one)), s
            single = fused_mlp.fused_rays_planes_bwd(kp_s, *one, g[:, s].contiguous())
            for k, v in single.items():
                if R % 64 == 0:
                    assert _same_bits(grads[k][s], v), (s, k)
                else:
                    assert _rel_l2(grads[k][s], v) <= gtol, (s, k)


# The stacked K2/K3 and K5/K6 of multi-scene training (one launch for S
# scenes, each tile on its own scene's weights; K6's compositing pass once
# over every scene's rays), against their plain versions (the single-scene
# kernels' scene by scene) at this file's bounds, and against S
# single-scene launches at 1, 127 and 129 rays a scene. A scene's points
# (rays) are padded to whole tiles, views and 64-view columns (whole ray
# groups), so each tile computes what the single-scene kernel computes for
# it alone: raw and the maps equal S single launches bit for bit; the grads
# too where no scene is padded (none of these shapes: a padded scene's
# weight grads sum in other splits, within the bound). (R, N, spr) of K2s
# and K3s: a direction per point at odd N (the renderer's), per ray at 16.
STACKED_POINTS_CASES = ((1, 63, 1), (127, 15, 1), (129, 16, 16))
STACKED_RENDER_CASES = ((1, 64), (127, 192), (129, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, F32_TOL, K3_F32_TOL),
                                            (torch.bfloat16, BF16_TOL, K4_BF16_TOL)])
def test_stacked_k2_k3_match_plain_and_single_launches(cuda_device, width, dtype, tol, gtol):
    from nerf_tpu_torch.render.network import StackedNeRFMLP

    S = 3
    nets = [NeRFMLP(MLPConfig(width=width), seed=width + 10 + s, device=cuda_device)
            for s in range(S)]
    with torch.no_grad():
        kp = fused_mlp.pack_params(StackedNeRFMLP.from_nets(nets), PE_P, PE_V, dtype)
    for R, N, spr in STACKED_POINTS_CASES:
        pts = [_points(R * N + s, R, N, spr, cuda_device) for s in range(S)]
        x, v = (torch.stack(t) for t in zip(*pts))
        gen = torch.Generator(device=cuda_device).manual_seed(R)
        g = (0.5 + torch.rand(S, R * N, 4, device=cuda_device, generator=gen)) * 1e-4
        before = (fused_mlp.fused_points_stacked.launches,
                  fused_mlp.fused_points_stacked_bwd.launches)
        out = fused_mlp.fused_points_stacked(kp, x, v, spr)
        grads = fused_mlp.fused_points_stacked_bwd(kp, x, v, g, spr)
        torch.cuda.synchronize()
        assert (fused_mlp.fused_points_stacked.launches,
                fused_mlp.fused_points_stacked_bwd.launches) == (before[0] + 1, before[1] + 1)
        assert out.shape == (S, R * N, 4)
        err = float((out - fused_mlp.fused_points_stacked_reference(kp, x, v, spr)).abs().max())
        ref_g = fused_mlp.fused_points_stacked_bwd_reference(kp, x, v, g, spr)
        gerr = max(_rel_l2(grads[k][s], ref_g[k][s]) for k in ref_g for s in range(S))
        print(f"stacked K2/K3 W={width} {dtype} S={S} R={R} N={N} spr={spr}: K2 max abs "
              f"{err:.3e}, K3 worst leaf {gerr:.3e}")  # with -s
        assert err <= tol and gerr <= gtol, (R, N, spr, err, gerr)
        for s in range(S):
            kp_s = {k: t[s].contiguous() for k, t in kp.items()}
            assert _same_bits(out[s], fused_mlp.fused_points(kp_s, x[s], v[s], spr)), s
            single, _, _ = fused_mlp.fused_points_bwd(kp_s, x[s], v[s], g[s].contiguous(), spr,
                                                      input_grads=False)
            for k, t in single.items():
                assert _rel_l2(grads[k][s], t) <= gtol, (s, k)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, F32_TOL, K4_F32_TOL),
                                            (torch.bfloat16, BF16_TOL, K4_BF16_TOL)])
def test_stacked_k5_k6_match_plain_and_single_launches(cuda_device, width, dtype, tol, gtol):
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.render.network import StackedNeRFMLP

    S = 3
    nets = [NeRFMLP(MLPConfig(width=width), seed=width + 20 + s, device=cuda_device)
            for s in range(S)]
    with torch.no_grad():
        kp = fused_mlp.pack_params(StackedNeRFMLP.from_nets(nets), PE_P, PE_V, dtype)
    for i, (R, N) in enumerate(STACKED_RENDER_CASES):
        white = i % 2 == 0
        ro, rd, vd, z, noise = (torch.stack(t) for t in zip(*(
            _render_inputs(R + N + s, R, N, cuda_device) for s in range(S))))
        gen = torch.Generator(device=cuda_device).manual_seed(R + N)
        g = [(0.5 + torch.rand(S, *sh, device=cuda_device, generator=gen)) * 1e-4
             for sh in ((R, 3), (R,), (R,), (R, N))]
        counters = (fused_render.fused_render_stacked_fwd, fused_render.fused_render_stacked_bwd,
                    fused_render.composite_bwd, fused_mlp.fused_rays_planes_stacked_bwd)
        before = [c.launches for c in counters]
        out = fused_render.fused_render_stacked_fwd(kp, ro, rd, vd, z, noise, white,
                                                    keep_raw=True)
        grads = fused_render.fused_render_stacked_bwd(kp, ro, rd, vd, z, noise, out.raw, *g, white)
        torch.cuda.synchronize()
        # one K5s, one K6s with its one compositing pass, no K4s counted
        assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0]
        with torch.no_grad():
            ref = fused_render.fused_render_stacked_reference(kp, ro, rd, vd, z, noise, white)
        err = _maps_err(out, ref)
        # the residual raw: the stacked K1's planes bit for bit
        assert torch.equal(out.raw, fused_mlp.fused_rays_planes_stacked(kp, ro, rd, vd, z))
        # serving (no raw planes: a slab per CTA of the (x, scene) grid)
        served = fused_render.fused_render_stacked_fwd(kp, ro, rd, vd, z, noise, white)
        assert served.raw is None and all(_same_bits(a, b) for a, b in zip(served[:4], out[:4]))
        ref_g = fused_render.fused_render_stacked_bwd_reference(kp, ro, rd, vd, z, noise, out.raw,
                                                                *g, white)
        gerr = max(_rel_l2(grads[k][s], ref_g[k][s]) for k in ref_g for s in range(S))
        print(f"stacked K5/K6 W={width} {dtype} white={white} S={S} R={R} N={N}: maps max abs "
              f"{err:.3e}, K6 worst leaf {gerr:.3e}")  # with -s
        assert err <= tol and gerr <= gtol, (R, N, err, gerr)
        for s in range(S):
            kp_s = {k: t[s].contiguous() for k, t in kp.items()}
            one_in = [t[s] for t in (ro, rd, vd, z, noise)]
            one = fused_render.fused_render_fwd(kp_s, *one_in, white, keep_raw=True)
            assert all(_same_bits(a[s], b) for a, b in zip(out[:4], one[:4])), s
            single = fused_render.fused_render_bwd(kp_s, *one_in, one.raw,
                                                   *(t[s].contiguous() for t in g), white)
            for k, t in single.items():
                assert _rel_l2(grads[k][s], t) <= gtol, (s, k)


# The wide kernel family (csrc/fused_mlp_wide.cu, ops/fused_mlp_wide.py):
# K1w-K6w at the widths and octave counts the W <= 256 tile is not built
# for. Configurations (width, point octaves, view octaves): NeRF-W's 512,
# mip-NeRF 360's 1024, a width whose half is not a multiple of 128 (384),
# and mip-NeRF's 16 point octaves at the tile's width; f32 at 384.
WIDE_BF16 = ((384, 10, 4), (512, 10, 4), (1024, 10, 4), (256, 16, 6))
WIDE_F32 = ((384, 10, 4),)
# (R, S): 1, 127 and 129 points (a GEMM tile's edges; S = 1: a direction per
# point) and 33,984 points (531 rays of 64: a direction per ray, a ragged
# last tile)
WIDE_CASES = ((1, 1), (127, 1), (129, 1), (531, 64))


def _wide_net(W, fp, fv, dev, seed, dtype):
    cfg = MLPConfig(width=W, input_ch=3 + 6 * fp, input_ch_views=3 + 6 * fv)
    mlp = NeRFMLP(cfg, seed=seed, device=dev)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, PosEncConfig(fp), PosEncConfig(fv), dtype)
    assert fused_mlp.is_wide(kp) and fused_mlp.supports(cfg, PosEncConfig(fp), PosEncConfig(fv))
    return kp


def _poison(dev):
    """Fill 1 GB of the caching allocator's free memory with NaN, so that
    outputs a kernel leaves unwritten show."""
    del dev  # the current device's allocator
    junk = torch.full((1 << 28,), float("nan"), device="cuda")
    del junk


def _wide_params():
    return ([pytest.param(c, torch.bfloat16, id=f"bf16-{c[0]}-{c[1]}-{c[2]}") for c in WIDE_BF16]
            + [pytest.param(c, torch.float32, id=f"f32-{c[0]}-{c[1]}-{c[2]}") for c in WIDE_F32])


# bf16 forward: as the tile's bound, both sides round the same operands;
# measured up to 3.0e-4 on an H100 (W=384, 531 x 64; PERF.md §6). f32:
# nerf_tpu's 1e-5 (measured up to 6.7e-8).
WIDE_BF16_TOL, WIDE_F32_TOL = 2e-3, 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("config,dtype", _wide_params())
def test_wide_forward_kernels_match_plain_versions(cuda_device, config, dtype):
    from nerf_tpu_torch.ops import fused_mlp_wide

    kp = _wide_net(*config, cuda_device, sum(config), dtype)
    tol = WIDE_BF16_TOL if dtype == torch.bfloat16 else WIDE_F32_TOL
    for R, S in WIDE_CASES:
        ro, rd, vd, z = _rays(R * S + 5, R, S, cuda_device)
        x = fused_mlp._ray_points(ro, rd, z)
        for kernel in ("K1w", "K2w"):
            counter = (fused_mlp_wide.fused_rays_planes_wide if kernel == "K1w"
                       else fused_mlp_wide.fused_points_wide)
            before = counter.launches
            _poison(cuda_device)
            if kernel == "K1w":
                out = fused_mlp.fused_rays_planes(kp, ro, rd, vd, z)
                again = fused_mlp.fused_rays_planes(kp, ro, rd, vd, z)
                ref = fused_mlp.fused_rays_planes_reference(kp, ro, rd, vd, z)
            else:
                out = fused_mlp.fused_points(kp, x, vd, S)
                again = fused_mlp.fused_points(kp, x, vd, S)
                ref = fused_mlp.fused_points_reference(kp, x, vd, S)
            torch.cuda.synchronize()
            assert counter.launches == before + 2
            assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
            err = float((out - ref).abs().max())
            print(f"{kernel} {config} {dtype} R={R} S={S}: max abs {err:.3e}")  # with -s
            assert err <= tol, (kernel, R, S, err)


# the wide backward against its plain version, per-leaf relative L2, for a
# cotangent of one sign per channel. f32: K3's bounds (the sums over points
# run in another order). bf16: a cotangent whose f32 sum lands on the other
# side of a bf16 rounding edge rounds to the other neighbour, and at W =
# 1024 a layer sums 4x the terms of W = 256 over as few as 127 points: the
# first layers' small, cancelling sums measured up to 1.04e-2 (K6w, R=127,
# S=8) and dx up to 1.79e-2 (R=129, S=1) on an H100 (PERF.md §6), so
# ~3x those, inside nerf_tpu's bf16 grad bound of 0.05 for the weight grads.
# The bf16 plain version is as far off: at W = 1024 on 127 and 129 points,
# each against the f32 plain version, no leaf of the kernel's is more than
# 1.4% farther than the plain version's same leaf (chip_smoke.py's
# wide_witness; PERF.md §6)
WIDE_GRAD_BF16_TOL, WIDE_INPUT_GRAD_BF16_TOL = 3e-2, 5e-2
@pytest.mark.cuda
@pytest.mark.parametrize("config,dtype", _wide_params())
def test_wide_backward_kernels_match_plain_versions(cuda_device, config, dtype):
    from nerf_tpu_torch.ops import fused_mlp_wide

    kp = _wide_net(*config, cuda_device, sum(config) + 1, dtype)
    bf16 = dtype == torch.bfloat16
    tol, in_tol = ((WIDE_GRAD_BF16_TOL, WIDE_INPUT_GRAD_BF16_TOL) if bf16
                   else (K3_F32_TOL, INPUT_GRAD_F32_TOL))
    for R, S in WIDE_CASES:
        ro, rd, vd, z = _rays(R * S + 6, R, S, cuda_device)
        x = fused_mlp._ray_points(ro, rd, z)
        gen = torch.Generator(device=cuda_device).manual_seed(R)
        g = (0.5 + torch.rand(4, R, S, device=cuda_device, generator=gen)) * 1e-4
        g_rows = g.reshape(4, -1).T.contiguous()
        k4, k3 = fused_mlp_wide.fused_rays_planes_wide_bwd, fused_mlp_wide.fused_points_wide_bwd
        before = (k4.launches, k3.launches)
        _poison(cuda_device)
        got4 = fused_mlp.fused_rays_planes_bwd(kp, ro, rd, vd, z, g)
        again4 = fused_mlp.fused_rays_planes_bwd(kp, ro, rd, vd, z, g)
        got3 = fused_mlp.fused_points_bwd(kp, x, vd, g_rows, S, True)
        torch.cuda.synchronize()
        assert (k4.launches, k3.launches) == (before[0] + 2, before[1] + 1)
        ref4 = fused_mlp.fused_rays_planes_bwd_reference(kp, ro, rd, vd, z, g)
        ref3 = fused_mlp.fused_points_bwd_reference(kp, x, vd, g_rows, S, True)
        errs = {}
        for name in fused_mlp.KP_NAMES:
            assert got4[name].shape == kp[name].shape == got3[0][name].shape, name
            assert torch.equal(got4[name], again4[name]), name  # no atomics: bit-identical
            errs[name] = max(_rel_l2(got4[name], ref4[name]), _rel_l2(got3[0][name], ref3[0][name]))
        errs.update(dx=_rel_l2(got3[1], ref3[1]), dv=_rel_l2(got3[2], ref3[2]))
        worst = max((e, n) for n, e in errs.items() if n not in ("dx", "dv"))
        print(f"K4w/K3w {config} {dtype} R={R} S={S}: worst leaf {worst[1]} {worst[0]:.3e}, "
              f"dx {errs['dx']:.3e}, dv {errs['dv']:.3e}")  # with -s
        assert worst[0] <= tol, (R, S, worst)
        assert errs["dx"] <= in_tol and errs["dv"] <= in_tol, (R, S, errs["dx"], errs["dv"])


@pytest.mark.cuda
@pytest.mark.parametrize("config,dtype", _wide_params())
def test_wide_render_kernels_match_plain_versions(cuda_device, config, dtype):
    from nerf_tpu_torch.experimental import fused_render

    kp = _wide_net(*config, cuda_device, sum(config) + 2, dtype)
    bf16 = dtype == torch.bfloat16
    for R, S in ((1, 64), (127, 8), (129, 64), (531, 64)):
        ro, rd, vd, z, noise = _render_inputs(R + S, R, S, cuda_device)
        k5, k6 = fused_render.fused_render_wide_fwd, fused_render.fused_render_wide_bwd
        before = (k5.launches, k6.launches)
        _poison(cuda_device)
        out = fused_render.fused_render_fwd(kp, ro, rd, vd, z, noise, True, keep_raw=True)
        with torch.no_grad():
            ref = fused_render.fused_render_reference(kp, ro, rd, vd, z, noise, True)
        err = _maps_err(out, ref)
        # the raw beneath the maps is K1w's, and the compositing K5's from it
        assert torch.equal(out.raw, fused_mlp.fused_rays_planes(kp, ro, rd, vd, z))
        gen = torch.Generator(device=cuda_device).manual_seed(R)
        cot = [(0.5 + torch.rand(t.shape, device=cuda_device, generator=gen)) * 1e-3
               for t in (out.rgb, out.disp, out.acc, out.w)]
        got = fused_render.fused_render_bwd(kp, ro, rd, vd, z, noise, out.raw, *cot, True)
        ref_g = fused_render.fused_render_bwd_reference(kp, ro, rd, vd, z, noise, out.raw, *cot,
                                                        True)
        torch.cuda.synchronize()
        assert (k5.launches, k6.launches) == (before[0] + 1, before[1] + 1)
        worst = max(_rel_l2(got[n], ref_g[n]) for n in fused_mlp.KP_NAMES)
        print(f"K5w/K6w {config} {dtype} R={R} S={S}: maps max abs {err:.3e}, "
              f"worst leaf {worst:.3e}")  # with -s
        assert err <= (BF16_TOL if bf16 else F32_TOL), (R, S, err)
        assert worst <= (WIDE_GRAD_BF16_TOL if bf16 else K3_F32_TOL), (R, S, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_primitives_match_plain_versions(cuda_device, dtype):
    """Each launch of csrc/fused_mlp_wide.cu against ops/fused_mlp_wide.py's
    PlainOps on the same inputs: the GEMM at its edges (1, 2 sources; M of
    63, 192, 320; k of 4, 27, 64 and 640; every epilogue step), the
    embedding, the head, gc, the per-ray sums, the posenc backward and the
    weight grads."""
    from nerf_tpu_torch.ops import fused_mlp_wide as wide

    dev = cuda_device
    ops, plain = wide.Ops(dtype, dev), wide.PlainOps()
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    bf16 = dtype == torch.bfloat16
    # the same operands rounded: both sides multiply exact products, so only
    # the f32 sums' order differs (and a bf16 output's rounding edge: an ulp)
    rel = 2.0 ** -7 if bf16 else 1e-5
    N = 2 * wide.TILE
    for M, k0, k1, opts in ((63, 64, 0, {}), (192, 640, 27, {"relu": True}),
                            (320, 4, 0, {"mask": True}), (128, 256, 4, {"add": 8})):
        a0 = rnd(M, -(-k0 // 8) * 8 + 8).to(dtype)  # rows a multiple of 16 bytes apart
        b0 = rnd(k0, N + 256).to(dtype)
        srcs = [(a0, k0, b0)]
        if k1:
            srcs.append((rnd(M, 32).to(dtype), k1, rnd(k1, N).to(dtype)))
        kw = dict(bias=rnd(M), relu=opts.get("relu", False))
        if "mask" in opts:
            kw["mask"] = rnd(M, N).to(dtype)
        if "add" in opts:
            kw.update(add=rnd(M, N // opts["add"]), add_div=opts["add"])
        got = [torch.full((M, N), float("nan"), dtype=dtype, device=dev),
               torch.full((M, N), float("nan"), device=dev),
               torch.full((N // wide.TILE, M + 3), float("nan"), device=dev)]
        want = [torch.empty_like(t) for t in got]
        ops.gemm(M, N, srcs, out=got[0], out32=got[1], bsum=got[2][:, :M], **kw)
        plain.gemm(M, N, srcs, out=want[0], out32=want[1], bsum=want[2][:, :M], **kw)
        torch.cuda.synchronize()
        scale = float(want[1].abs().max())
        for g, w in zip(got[:2], want[:2]):
            d = (g.float() - w.float()).abs()
            assert float(d.max()) <= rel * scale + 1e-5 * scale, (M, k0, k1, float(d.max()))
        assert float((got[2][:, :M] - want[2][:, :M]).abs().max()) <= 1e-3 * float(
            want[2][:, :M].abs().max()) + 1e-4
        assert bool(torch.isnan(got[2][:, M:]).all())  # nothing past M
    ro, rd, vd, z = _rays(9, 50, 7, dev)
    x = fused_mlp._ray_points(ro, rd, z)
    for F_, K in ((10, 64), (16, 128)):
        got = torch.full((K, 512), float("nan"), dtype=dtype, device=dev)
        want = torch.empty_like(got)
        ops.embed(got, F_, 350, rays=(ro, rd, z, 7))
        plain.embed(want, F_, 350, rays=(ro, rd, z, 7))
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) <= (2.0 ** -8 if bf16 else 2e-6)
        ops.embed(got, F_, 350, x=x)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) <= (2.0 ** -8 if bf16 else 2e-6)
        de = rnd(3 + 6 * F_, 512)
        dx, dx_ref = torch.empty(350, 3, device=dev), torch.empty(350, 3, device=dev)
        ops.embed_bwd(x, 350, F_, de, dx)
        plain.embed_bwd(x, 350, F_, de, dx_ref)
        torch.cuda.synchronize()
        assert _rel_l2(dx, dx_ref) <= 1e-5
    hv, h7 = rnd(192, 512).to(dtype), rnd(384, 512).to(dtype)
    wout, bout = rnd(576, 4).to(dtype), rnd(4)
    got, want = torch.empty(350, 4, device=dev), torch.empty(350, 4, device=dev)
    ops.head(hv, h7, 350, 384, wout, bout, got.T)
    plain.head(hv, h7, 350, 384, wout, bout, want.T)
    g = rnd(4, 350)
    rows = [torch.full((8, 512), float("nan"), dtype=dtype, device=dev) for _ in range(2)]
    bs = [torch.full((2, 4), float("nan"), device=dev) for _ in range(2)]
    ops.gc(g, 350, rows[0], bs[0])
    plain.gc(g, 350, rows[1], bs[1])
    dhv = rnd(96, 512)
    sums = [torch.full((96, 128), float("nan"), dtype=dtype, device=dev) for _ in range(2)]
    ops.ray_sums(dhv, 50, 7, sums[0])
    plain.ray_sums(dhv, 50, 7, sums[1])
    torch.cuda.synchronize()
    assert _rel_l2(got, want) <= 1e-5
    assert torch.equal(rows[0], rows[1]) and _rel_l2(bs[0], bs[1]) <= 1e-5
    assert float((sums[0].float() - sums[1].float()).abs().max()) <= 2.0 ** -7 * float(
        sums[1].float().abs().max())
    # the weight grads over rows of a workspace and of per-ray rows
    ws, rws = rnd(700, 640).to(dtype), rnd(96, 128).to(dtype)
    bpart = rnd(5, 40)
    probs = [(0, 0, 64, 100, 256, 0, 256), (0, 64, 192, 300, 192, 20_000, 192),
             (0, 400, 300, 696, 4, 60_000, 4), (1, 0, 32, 32, 64, 70_000, 64)]
    probs = [q + wide.cluster_shape(q[2], q[4]) for q in probs]
    grad_size = 80_000
    outs = [torch.full((1, grad_size + 40), float("nan"), device=dev) for _ in range(2)]
    for o, impl in zip(outs, (ops, plain)):
        o[:, :grad_size] = 0
        split_len, nsplit = wide._splits(bf16, probs, 640)
        impl.wgrad(ws, rws, probs, split_len, nsplit, grad_size, o, bpart)
    torch.cuda.synchronize()
    assert _rel_l2(outs[0], outs[1]) <= 1e-5
    # two scenes' columns side by side, each scene's grads its own set
    outs = [torch.full((2, grad_size + 40), float("nan"), device=dev) for _ in range(2)]
    ws2, rws2, bpart2 = rnd(700, 1280).to(dtype), rnd(96, 256).to(dtype), rnd(10, 40)
    for o, impl in zip(outs, (ops, plain)):
        o[:, :grad_size] = 0
        split_len, nsplit = wide._splits(bf16, probs, 640)
        impl.wgrad(ws2, rws2, probs, split_len, nsplit, grad_size, o, bpart2, 2)
    torch.cuda.synchronize()
    assert _rel_l2(outs[0], outs[1]) <= 1e-5


# The bf16 weight grads in thread-block clusters (csrc/wgrad_sm90.cuh:
# each product whole, its 128 x 256 tiles in clusters of mc x nc CTAs that
# share each K chunk by TMA multicast) against PlainOps.wgrad (each product
# in f32): whole products of N = 512 and 1024 (4 x 2 clusters, tiling C at
# 1024), an M <= 64 product (one consumer warpgroup) beside M = 512 ones in
# one launch, the per-ray problem, two scenes, and M and N at the clusters'
# edges (M = 192: a 2 x 1 cluster whose second CTA has 64 rows; M = 320:
# three M-tiles, 1 x 2; N = 384: a 256- and a 128-column tile in one
# cluster). Each case also launched twice, bit for bit.
WGRAD_CASES = {
    # name: ([(src, ra, M, rb, N)], columns a scene, per-ray columns, scenes)
    "whole_512": ([(0, 0, 512, 512, 512), (0, 1024, 512, 1536, 256)], 4096, 0, 1),
    "whole_1024": ([(0, 0, 1024, 1024, 1024)], 2048, 0, 1),
    "mixed_m64": ([(0, 0, 63, 64, 512), (0, 576, 512, 1088, 512), (0, 64, 512, 1600, 4)],
                  4096, 0, 1),
    "per_ray_two_scenes": ([(0, 0, 512, 512, 512), (1, 0, 32, 32, 256)], 2560, 640, 2),
    "edges": ([(0, 0, 192, 200, 384), (0, 400, 320, 720, 384), (0, 1100, 64, 1200, 256)],
              1984, 0, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WGRAD_CASES))
def test_wgrad_clusters_match_plain_version(cuda_device, case):
    from nerf_tpu_torch.ops import fused_mlp_wide as wide

    dev = cuda_device
    spec, C, Cr, scenes = WGRAD_CASES[case]
    ops, plain = wide.Ops(torch.bfloat16, dev), wide.PlainOps()
    gen = torch.Generator(device=dev).manual_seed(len(case))
    ws = torch.randn(2100, scenes * C, device=dev, generator=gen).to(torch.bfloat16)
    rws = torch.randn(300, scenes * Cr, device=dev, generator=gen).to(torch.bfloat16) if Cr \
        else None
    probs, off = [], 0
    for src, ra, M, rb, N in spec:
        probs.append((src, ra, M, rb, N, off, N) + wide.cluster_shape(M, N))
        off += M * N
    assert max(q[7] * q[8] for q in probs) > 1  # a cluster launch
    bpart = torch.randn(scenes * C // wide.TILE, 40, device=dev, generator=gen)
    split_len, nsplit = wide._splits(True, probs, C, ops.cluster_slots)
    outs = [torch.full((scenes, off + 40), float("nan"), device=dev) for _ in range(3)]
    for o, impl in zip(outs, (ops, ops, plain)):
        impl.wgrad(ws, rws, probs, split_len, nsplit, off, o, bpart, scenes)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])  # two launches bit-identical
    for q in probs:
        block = slice(q[5], q[5] + q[2] * q[4])
        err = _rel_l2(outs[0][:, block], outs[2][:, block])
        print(f"wgrad {case} M={q[2]} N={q[4]} cluster {q[7]}x{q[8]}: rel L2 {err:.2e}")  # -s
        assert err <= 1e-5, (q, err)
    assert _rel_l2(outs[0], outs[2]) <= 1e-5


# The wide GEMM alone (gemm_bf16_sm90: persistent, 128 x 256 tiles on
# wgmma m64n256k16 with B MN-major across four 64-point swizzle atoms, an
# epilogue staged through shared memory) against PlainOps.gemm: M at and
# around the 64-row warpgroup and 128-row tile edges, one and two sources,
# each epilogue step, one scene and three (each its own weights, bias and
# per-view terms), one tile of points and several. Random B rows differ in
# every column, so each of a tile's four swizzle atoms holds other values:
# a wrong atom stride reads another atom's points.
GEMM_MS = (4, 8, 128, 192, 256, 320, 448, 512, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("scenes", [1, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_gemm_matches_plain_version(cuda_device, scenes, dtype):
    from nerf_tpu_torch.ops import fused_mlp_wide as wide

    dev = cuda_device
    ops, plain = wide.Ops(dtype, dev), wide.PlainOps()
    gen = torch.Generator(device=dev).manual_seed(scenes)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    opts = ({}, {"relu": True}, {"mask": True}, {"add": 64}, {"relu": True, "add": 8})
    for i, M in enumerate(GEMM_MS):
        C = wide.TILE * (1 + i % 3)  # a scene's points: one tile, two or three
        N = scenes * C
        k0, k1 = (64, 0) if i % 2 else (192 + 8 * i, 4 + 8 * i)
        opt = opts[i % len(opts)]
        lda = lambda k: -(-(k + 8) // 8) * 8  # noqa: E731  rows a multiple of 16 bytes apart
        a0 = rnd(scenes, M, lda(k0)).to(dtype)  # each scene its own weights
        srcs = [(a0 if scenes > 1 else a0[0], k0, rnd(k0, N).to(dtype))]
        if k1:
            a1 = rnd(scenes, M, lda(k1)).to(dtype)
            srcs.append((a1 if scenes > 1 else a1[0], k1, rnd(k1, N).to(dtype)))
        bias = rnd(scenes, M)
        kw = dict(bias=bias if scenes > 1 else bias[0], relu=opt.get("relu", False),
                  scenes=scenes)
        if "mask" in opt:
            kw["mask"] = rnd(M, N).to(dtype)
        if "add" in opt:
            add = rnd(M, scenes, C // opt["add"]).permute(1, 0, 2)
            kw.update(add=add if scenes > 1 else add[0], add_div=opt["add"])
        got = [torch.full((M, N), float("nan"), dtype=dtype, device=dev),
               torch.full((M, N), float("nan"), device=dev),
               torch.full((N // wide.TILE, M + 3), float("nan"), device=dev)]
        want = [torch.empty_like(t) for t in got]
        ops.gemm(M, N, srcs, out=got[0], out32=got[1], bsum=got[2][:, :M], **kw)
        again = torch.empty_like(got[0])
        ops.gemm(M, N, srcs, out=again, **kw)
        plain.gemm(M, N, srcs, out=want[0], out32=want[1], bsum=want[2][:, :M], **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], again)  # no atomics: bit-identical
        scale = float(want[1].abs().max())
        for g, w in zip(got[:2], want[:2]):
            d = float((g.float() - w.float()).abs().max())
            print(f"gemm {dtype} S={scenes} M={M} C={C} k={k0}+{k1} {opt}: max abs {d:.3e} "
                  f"of {scale:.3e}")  # with -s
            assert d <= rel * scale + 1e-5 * scale, (M, C, k0, k1, opt, d)
        assert float((got[2][:, :M] - want[2][:, :M]).abs().max()) <= 1e-3 * float(
            want[2][:, :M].abs().max()) + 1e-4
        assert bool(torch.isnan(got[2][:, M:]).all())  # nothing past M


@pytest.mark.cuda
def test_wide_gemm_swizzle_atoms(cuda_device):
    """One 128 x 256 tile whose four 64-point swizzle atoms of B hold
    different constants (atom j: j + 1): each output column's value names
    the atom it read."""
    from nerf_tpu_torch.ops import fused_mlp_wide as wide

    dev = cuda_device
    ops = wide.Ops(torch.bfloat16, dev)
    M, K = 128, 64
    a = torch.zeros(M, K, device=dev, dtype=torch.bfloat16)
    a[:, 0] = 1  # C[m][n] = B[0][n]
    b = torch.zeros(K, wide.TILE, device=dev, dtype=torch.bfloat16)
    b[0] = (torch.arange(wide.TILE, device=dev) // 64 + 1).to(torch.bfloat16)
    b[1:] = 100  # the rows past K's first read by no column with a = 0 there
    out = torch.full((M, wide.TILE), float("nan"), device=dev)
    ops.gemm(M, wide.TILE, [(a, K, b)], out32=out)
    torch.cuda.synchronize()
    want = (torch.arange(wide.TILE, device=dev) // 64 + 1).float().expand(M, -1)
    assert torch.equal(out, want), out[0, ::32]


# The stacked wide plans on the card (K1ws-K6ws: S nets a launch, each
# scene's rays or views padded to whole 256-point tiles): against their
# plain versions (the single-scene plain versions scene by scene) and, bit
# for bit, against single-scene wide launches on each scene's own net, at
# the wide configurations, with 1, 127 and 129 points a scene (a direction
# a point) and rays of 64 samples (a direction a ray).
STACKED_WIDE_CASES = ((1, 1), (127, 1), (129, 1), (3, 64))


def _stacked_wide_net(W, fp, fv, dev, seed, dtype, S=3):
    from nerf_tpu_torch.render.network import StackedNeRFMLP

    cfg = MLPConfig(width=W, input_ch=3 + 6 * fp, input_ch_views=3 + 6 * fv)
    nets = [NeRFMLP(cfg, seed=seed + s, device=dev) for s in range(S)]
    with torch.no_grad():
        kp = fused_mlp.pack_params(StackedNeRFMLP.from_nets(nets), PosEncConfig(fp),
                                   PosEncConfig(fv), dtype)
    assert fused_mlp.is_wide(kp) and fused_mlp.supports_stacked(cfg, PosEncConfig(fp),
                                                                PosEncConfig(fv))
    return kp


@pytest.mark.cuda
@pytest.mark.parametrize("config", WIDE_BF16)
def test_stacked_wide_kernels_match_plain_and_single_scene(cuda_device, config):
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.ops import fused_mlp_wide as wide

    dev, S = cuda_device, 3
    kp = _stacked_wide_net(*config, dev, sum(config) + 3, torch.bfloat16, S)
    one = [{k: t[s].contiguous() for k, t in kp.items()} for s in range(S)]
    counters = (wide.fused_rays_planes_wide_stacked, wide.fused_rays_planes_wide_stacked_bwd,
                wide.fused_points_wide_stacked, wide.fused_points_wide_stacked_bwd,
                fused_render.fused_render_wide_stacked_fwd,
                fused_render.fused_render_wide_stacked_bwd)
    for R, N in STACKED_WIDE_CASES:
        rays = [torch.stack(t) for t in zip(*(_rays(R * N + s, R, N, dev) for s in range(S)))]
        ro, rd, vd, z = rays
        gen = torch.Generator(device=dev).manual_seed(R + N)
        g = (0.5 + torch.rand(4, S, R, N, device=dev, generator=gen)) * 1e-4
        x = torch.stack([fused_mlp._ray_points(ro[s], rd[s], z[s]) for s in range(S)])
        gp = g.permute(1, 2, 3, 0).reshape(S, R * N, 4).contiguous()
        before = [c.launches for c in counters]
        _poison(dev)
        raw = fused_mlp.fused_rays_planes_stacked(kp, *rays)
        grads = fused_mlp.fused_rays_planes_stacked_bwd(kp, *rays, g)
        raw2 = fused_mlp.fused_points_stacked(kp, x, vd, N)
        grads2 = fused_mlp.fused_points_stacked_bwd(kp, x, vd, gp, N)
        want = [1, 1, 1, 1, 0, 0]
        if N % 8 == 0:
            noise = torch.randn(S, R, N, device=dev, generator=gen)
            maps = fused_render.fused_render_stacked_fwd(kp, *rays, noise, True, keep_raw=True)
            cot = [(0.5 + torch.rand(t.shape, device=dev, generator=gen)) * 1e-3
                   for t in maps[:4]]
            grads6 = fused_render.fused_render_stacked_bwd(kp, *rays, noise, maps.raw, *cot, True)
            want[4:] = [1, 1]
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == want
        assert bool(torch.isfinite(raw).all())
        ref = fused_mlp.fused_rays_planes_stacked_reference(kp, *rays)
        err = float((raw - ref).abs().max())
        gref = fused_mlp.fused_rays_planes_stacked_bwd_reference(kp, *rays, g)
        gerr = max(_rel_l2(grads[k][s], gref[k][s]) for k in gref for s in range(S))
        print(f"K1ws/K4ws {config} S={S} R={R} N={N}: max abs {err:.3e}, worst leaf "
              f"{gerr:.3e}")  # with -s
        assert err <= WIDE_BF16_TOL and gerr <= WIDE_GRAD_BF16_TOL, (R, N, err, gerr)
        assert float((raw2 - fused_mlp.fused_points_stacked_reference(kp, x, vd, N)).abs().max()) \
            <= WIDE_BF16_TOL
        for s in range(S):  # bit for bit: scene s of the stacked plans is its single-scene plan
            assert torch.equal(raw[:, s], fused_mlp.fused_rays_planes(one[s], ro[s], rd[s], vd[s],
                                                                      z[s])), s
            single = fused_mlp.fused_rays_planes_bwd(one[s], ro[s], rd[s], vd[s], z[s],
                                                     g[:, s].contiguous())
            assert all(torch.equal(grads[k][s], t) for k, t in single.items()), s
            assert torch.equal(raw2[s], fused_mlp.fused_points(one[s], x[s], vd[s], N)), s
            single, _, _ = fused_mlp.fused_points_bwd(one[s], x[s], vd[s], gp[s], N, False)
            assert all(torch.equal(grads2[k][s], t) for k, t in single.items()), s
            if N % 8 == 0:
                ins = [t[s] for t in (ro, rd, vd, z, noise)]
                o = fused_render.fused_render_fwd(one[s], *ins, True, keep_raw=True)
                assert all(_same_bits(a[s], b) for a, b in zip(maps[:4], o[:4])), s
                single = fused_render.fused_render_bwd(one[s], *ins, o.raw,
                                                       *(t[s].contiguous() for t in cot), True)
                assert all(torch.equal(grads6[k][s], t) for k, t in single.items()), s


# the fused loop (ROADMAP A.3) and the sliced backward (ROADMAP C.8)


def _chunk_setup(dev, k):
    """A lego-recipe train state at W = 256 (8 layers, 64 + 128 samples,
    bf16: K1 and K4 on both levels), its step, a ray bank and a window of
    k steps of 512 rays into it."""
    from nerf_tpu_torch import config
    from nerf_tpu_torch.models.factory import init_nets, make_model
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.step import init_train_state, make_train_step

    cfg = config.load_config(["--dataset_type=blender", "--use_viewdirs", "--white_bkgd",
                              "--N_samples=64", "--N_importance=128", "--N_rand=512"])
    model, rs = make_model(cfg), render_settings_from_config(cfg)
    state = init_train_state(init_nets(model, 5, dev), cfg.lrate)
    step = make_train_step(model, rs, cfg.lrate, cfg.lrate_decay)
    ro, rd, _, _ = _rays(11, 4096, 1, dev)
    target = torch.rand(4096, 3, generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev)
    perm = torch.randperm(4096, generator=torch.Generator(device=dev).manual_seed(4),
                          device=dev)
    return cfg, model, state, step, (ro, rd, target), perm[: 2 * k * 512].view(2, k, 512)


@pytest.mark.cuda
def test_fused_loop_over_nccl_ranks_equals_step_by_step(cuda_device):
    """train() over an NCCL group, a card a rank (two ranks where the
    machine has two cards, else a one-rank group over its mesh), with
    fuse_steps 4 and with 1 (tools/dp_time.py's check_rank): history,
    parameters and Adam's state torch.equal on every rank, one graph
    replay a chunk with the all-reduces inside, the same launches."""
    from nerf_tpu_torch.parallel import distributed
    from nerf_tpu_torch.tools import dp_time

    ranks = distributed.launch(dp_time.check_rank, min(2, torch.cuda.device_count()), "cuda")
    for r in ranks:
        assert r["equal"], r
        assert r["fused"]["chunks"] == r["fused"]["replays"] == dp_time.CHECK_CHUNKS
        assert r["per_step"]["replays"] == 0
        assert r["fused"]["launches"] == r["per_step"]["launches"]
        assert r["history"] == ranks[0]["history"]


@pytest.mark.cuda
def test_graph_replay_of_a_chunk_equals_eager_steps(cuda_device):
    """Two chunks of a two-step CUDA graph (train/graph.py's ChunkRunner:
    captured at its first chunk after a warm-up step that is undone) against
    four eager steps of the same state, draws and learning rates: losses,
    parameters and Adam's state torch.equal; one replay a chunk; the
    launch counts those of the eager steps; the serving packing kept on
    a net before the chunks (fused_mlp.packed_params) rebuilt after them."""
    from nerf_tpu_torch.train.graph import ChunkRunner
    from nerf_tpu_torch.train.step import lr_schedule

    k, dev = 2, cuda_device
    runs = {}
    for fused in (True, False):
        cfg, model, state, step, (ro, rd, target), windows = _chunk_setup(dev, k)
        fine = state.nets["fine"]
        fused_mlp.packed_params(fine, model.pe_pts, model.pe_views, torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(6)
        near = torch.full((512,), 2.0, device=dev)
        far = torch.full((512,), 6.0, device=dev)
        schedule = lr_schedule(cfg.lrate, cfg.lrate_decay)
        table = torch.tensor([schedule(t) for t in range(2 * k)], dtype=torch.float32,
                             device=dev)
        before = (fused_mlp.fused_rays_planes.launches, fused_mlp.fused_rays_planes_bwd.launches)
        losses = []
        if fused:
            runner = ChunkRunner(functools.partial(step, generator=gen), state, k, near, far,
                                 [gen], table, 0)
            for w in windows:
                aux = runner.run("batch", lambda j, win: (ro[win[j]], rd[win[j]],
                                                          target[win[j]]), w)
                losses.append(aux["loss"])
            assert runner.replays == 2 and state.step == 2 * k
        else:
            for w in windows:
                for j in range(k):
                    aux = step(state, ro[w[j]], rd[w[j]], near, far, target[w[j]], generator=gen)
                    losses.append(aux["loss"][None])
        torch.cuda.synchronize()
        counts = (fused_mlp.fused_rays_planes.launches - before[0],
                  fused_mlp.fused_rays_planes_bwd.launches - before[1])
        kept, _ = fused_mlp.packed_params(fine, model.pe_pts, model.pe_views, torch.bfloat16)
        with torch.no_grad():
            fresh = fused_mlp.pack_params(fine, model.pe_pts, model.pe_views, torch.bfloat16)
        assert all(torch.equal(kept[n], fresh[n]) for n in fresh)
        runs[fused] = (torch.cat(losses), state, counts)
    (lf, sf, cf), (le, se, ce) = runs[True], runs[False]
    assert cf == ce == (4 * k, 4 * k)
    assert torch.equal(lf, le) and bool(torch.isfinite(lf).all())
    for level in ("coarse", "fine"):
        for a, b in zip(sf.nets[level].parameters(), se.nets[level].parameters()):
            assert torch.equal(a, b)
            assert all(torch.equal(sf.optimizer.state[a][key], se.optimizer.state[b][key])
                       for key in ("step", "exp_avg", "exp_avg_sq"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 5e-2)])
def test_sliced_k4_backward_matches_one_launch(cuda_device, dtype, tol, monkeypatch):
    """K4 through _FusedRaysPlanes with the workspace budget forced to 256
    rays of 1024: four launches whose grads, summed in f32, are the one
    launch's within ROADMAP's tolerances (f32 rtol 1e-5, bf16 relative L2
    below 0.05; per leaf)."""
    mlp = NeRFMLP(MLPConfig(width=256), seed=8, device=cuda_device)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
    leaves = [kp[n].detach().clone().requires_grad_(True) for n in fused_mlp.KP_NAMES]
    R, S = 1024, 64
    args = _rays(21, R, S, cuda_device)
    g = (0.5 + torch.rand(4, R, S, device=cuda_device,
                          generator=torch.Generator(device=cuda_device).manual_seed(9))) * 1e-4

    def grads():
        for t in leaves:
            t.grad = None
        before = fused_mlp.fused_rays_planes_bwd.launches
        fused_mlp._FusedRaysPlanes.apply(*args, *leaves).backward(g)
        torch.cuda.synchronize()
        return [t.grad.float() for t in leaves], fused_mlp.fused_rays_planes_bwd.launches - before

    one, n_one = grads()
    item = S * fused_mlp.bwd_point_bytes(kp, S)
    monkeypatch.setattr(fused_mlp, "WORKSPACE_BUDGET", 256 * item)
    sliced, n_sliced = grads()
    assert (n_one, n_sliced) == (1, 4)
    for name, a, b in zip(fused_mlp.KP_NAMES, sliced, one):
        assert _rel_l2(a, b) <= tol, (name, _rel_l2(a, b))
