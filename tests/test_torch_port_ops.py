"""The port's geometry, sampling and compositing against nerf_tpu on the CPU.

The compositor in both of its forms: the exact cumprod and nerf_tpu's
matmul scan, which the renderer takes for bf16 planes (ROADMAP A.7).

Inputs (and the random draws, through the override hooks) come from numpy
with a seed and go through both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nerf_tpu.geom import poses as jposes
from nerf_tpu.geom import rays as jrays
from nerf_tpu.ops import compositing as jcomp
from nerf_tpu.ops import sampling as jsamp
from nerf_tpu_torch.geom import poses as tposes
from nerf_tpu_torch.geom import rays as trays
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import compositing as tcomp
from nerf_tpu_torch.ops import sampling as tsamp
from nerf_tpu_torch.ops.sampling import linspace01
from nerf_tpu_torch.render import renderer
from nerf_tpu_torch.render.network import NeRFModel

F32_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(out, ref, tol=F32_TOL):
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


def test_spherical_poses_match_jax():
    np.testing.assert_array_equal(
        tposes.spherical_render_poses(40), jposes.spherical_render_poses(40)
    )
    np.testing.assert_array_equal(
        tposes.pose_spherical(12.5, -30.0, 4.0), jposes.pose_spherical(12.5, -30.0, 4.0)
    )


def test_rays_and_ndc_match_jax():
    H, W, f = 6, 8, 7.5
    K = np.array([[f, 0, 0.5 * W], [0, f, 0.5 * H], [0, 0, 1]], np.float32)
    c2w = jposes.pose_spherical(30.0, -30.0, 4.0)[:3, :4]
    ro, rd = trays.get_rays(H, W, _t(K), _t(c2w))
    jro, jrd = jrays.get_rays(H, W, K, c2w)
    _close(ro.contiguous(), jro)
    _close(rd, jrd)
    for a, b in zip(trays.get_rays_np(H, W, K, c2w), jrays.get_rays_np(H, W, K, c2w)):
        np.testing.assert_array_equal(a, b)
    no, nd = trays.ndc_rays(H, W, f, 1.0, ro, rd)
    jno, jnd = jrays.ndc_rays(H, W, f, 1.0, jro, jrd)
    _close(no, jno)
    _close(nd, jnd)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_z_vals_match_jax(lindisp):
    rng = np.random.default_rng(0)
    near = rng.uniform(1, 2, 5).astype(np.float32)
    far = rng.uniform(4, 6, 5).astype(np.float32)
    t_rand = rng.uniform(size=(5, 16)).astype(np.float32)
    for perturb in (False, True):
        kw = dict(lindisp=lindisp, perturb=perturb)
        ref = jsamp.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 16,
                                      t_rand=jnp.asarray(t_rand) if perturb else None, **kw)
        out = tsamp.stratified_z_vals(_t(near), _t(far), 16,
                                      t_rand=_t(t_rand) if perturb else None, **kw)
        _close(out, ref)
    # the unit sample positions agree bit for bit with jnp.linspace's rounding
    for n in (1, 2, 16, 64, 128):
        np.testing.assert_array_equal(
            linspace01(n).numpy(), np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32))
        )


@pytest.mark.parametrize("mode", ["det", "given_u", "peaked"])
def test_sample_pdf_matches_jax(mode):
    rng = np.random.default_rng(1)
    R, M, N = 6, 15, 24
    bins = np.sort(rng.uniform(2, 6, (R, M)).astype(np.float32), -1)
    weights = rng.uniform(0, 1, (R, M - 1)).astype(np.float32)
    if mode == "peaked":  # near-zero bins exercise the denom<1e-5 guard
        weights[:, :-1] = 0.0
    u = rng.uniform(size=(R, N)).astype(np.float32)
    u[0, :3] = [0.0, 1.0, 0.99999994]  # both ends of the CDF
    given = mode != "det"
    ref = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), N, det=not given,
                           u=jnp.asarray(u) if given else None)
    out = tsamp.sample_pdf(_t(bins), _t(weights), N, det=not given, u=_t(u) if given else None)
    _close(out, ref)


def test_random_draws_need_a_source():
    z = torch.ones(2, 4)
    with pytest.raises(ValueError):
        tsamp.stratified_z_vals(z[:, 0], 2 * z[:, 0], 4, perturb=True)
    with pytest.raises(ValueError):
        tsamp.sample_pdf(z, z[:, 1:], 3)
    g = torch.Generator().manual_seed(0)
    s = tsamp.sample_pdf(torch.arange(4.0).expand(2, 4), z[:, 1:], 3, generator=g)
    assert s.shape == (2, 3) and bool(((s >= 0) & (s <= 3)).all())


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_compositing_matches_jax(white_bkgd):
    rng = np.random.default_rng(2)
    R, S = 7, 24
    raw = rng.standard_normal((R, S, 4)).astype(np.float32) * 2
    raw[0, :, 3] = 50.0  # opaque ray: alpha == 1 exercises the 1e-10 floor
    z = np.sort(rng.uniform(2, 6, (R, S)).astype(np.float32), -1)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    noise = rng.standard_normal((R, S)).astype(np.float32)
    for nz in (None, noise):
        kw = dict(white_bkgd=white_bkgd, raw_noise_std=1.0 if nz is not None else 0.0)
        ref = jcomp.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                                noise=None if nz is None else jnp.asarray(nz), **kw)
        out = tcomp.raw2outputs(_t(raw), _t(z), _t(rd), noise=None if nz is None else _t(nz), **kw)
        planes = tcomp.raw2outputs_planes(_t(np.moveaxis(raw, -1, 0)), _t(z), _t(rd),
                                          noise=None if nz is None else _t(nz), **kw)
        for o in (out, planes):
            for name in ("rgb", "disp", "acc", "weights", "depth"):
                _close(getattr(o, name), getattr(ref, name))


def test_exclusive_cumprod_backward_is_torchs():
    """The compositor's cumprod (``compositing._Cumprod``, whose backward
    reads no value on the host, so that a CUDA graph can capture it) gives
    torch.cumprod's values and grads bit for bit on inputs with no zero,
    the 1e-10 floor of an opaque sample's 1 - alpha among them, and with a
    single sample."""
    gen = torch.Generator().manual_seed(0)
    for shape in ((7, 24), (3, 1), (2, 5, 192)):
        x = torch.rand(shape, generator=gen) * 0.999
        x[..., 0] = 1e-10
        x.requires_grad_(True)
        g = torch.randn(shape, generator=gen)
        ones = torch.ones_like(x[..., :1])
        want = torch.cumprod(torch.cat([ones, x], -1), -1)[..., :-1]
        got = tcomp.exclusive_cumprod(x)
        assert torch.equal(got, want)
        assert torch.equal(torch.autograd.grad(got, x, g)[0], torch.autograd.grad(want, x, g)[0])


def _planes(seed, R=32, S=48):
    """tests/test_compositing.py's planes: raw [4, R, S], sorted z, rays_d and
    the sigma noise."""
    rng = np.random.default_rng(seed)
    raw4 = rng.standard_normal((4, R, S)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (R, S)).astype(np.float32), -1)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    noise = rng.standard_normal((R, S)).astype(np.float32) * 0.4
    return raw4, z, rd, noise


def _port_planes(raw4, z, rd, noise, matmul_scan):
    """The port's maps and the gradient of rgb + acc + disp sums w.r.t. raw4."""
    r4 = _t(raw4).requires_grad_(True)
    o = tcomp.raw2outputs_planes(r4, _t(z), _t(rd), white_bkgd=True, noise=_t(noise),
                                 matmul_scan=matmul_scan)
    (o.rgb.sum() + o.acc.sum() + o.disp.sum()).backward()
    return o, r4.grad


MAPS = ("rgb", "disp", "acc", "weights", "depth")


@pytest.mark.parametrize("seed", [1, 3])
def test_matmul_scan_matches_jax(seed):
    """nerf_tpu's bf16-path compositor (``matmul_scan=True``), maps and the
    gradient w.r.t. raw, in f32: the same product, summed in another order."""
    raw4, z, rd, noise = _planes(seed)

    def loss(r4):
        o = jcomp.raw2outputs_planes(r4, jnp.asarray(z), jnp.asarray(rd), white_bkgd=True,
                                     noise=jnp.asarray(noise), matmul_scan=True)
        return o.rgb.sum() + o.acc.sum() + o.disp.sum(), o

    (_, ref), gref = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(raw4))
    out, g = _port_planes(raw4, z, rd, noise, True)
    for name in MAPS:
        _close(getattr(out, name).detach(), getattr(ref, name))
    _close(g, gref)


def test_matmul_scan_close_to_cumprod():
    """The port's two forms within nerf_tpu's own bound on them
    (tests/test_compositing.py::test_planes_matmul_scan_close)."""
    raw4, z, rd, noise = _planes(1)
    (o1, g1), (o2, g2) = (_port_planes(raw4, z, rd, noise, ms) for ms in (False, True))
    for name in MAPS:
        np.testing.assert_allclose(getattr(o2, name).detach().numpy(),
                                   getattr(o1, name).detach().numpy(), rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=2e-3, atol=1e-3)


def test_opaque_ray_finite_in_both_forms():
    """alpha == 1 keeps the 1e-10 floor, so the log of the matmul scan stays
    finite (tests/test_compositing.py::test_opaque_ray_planes_no_nan)."""
    n = 16
    raw4 = np.zeros((4, 1, n), np.float32)
    raw4[3, 0, 4] = 1e4
    raw4[:3] = 5.0
    z = _t(np.linspace(2.0, 6.0, n, dtype=np.float32)[None])
    rd = _t(np.array([[0.0, 0.0, -1.0]], np.float32))
    for ms in (False, True):
        r4 = _t(raw4).requires_grad_(True)
        o = tcomp.raw2outputs_planes(r4, z, rd, matmul_scan=ms)
        for name in ("rgb", "acc", "weights", "depth"):
            assert bool(torch.isfinite(getattr(o, name)).all()), (ms, name)
        w = o.weights.detach()[0]
        assert w[4] > 0.99 and bool((w[5:] < 1e-6).all())
        o.rgb.sum().backward()
        assert bool(torch.isfinite(r4.grad).all()), ms


def test_matmul_scan_keeps_ieee_f32_products():
    """Both of the scan's products (forward and backward) run with float32
    products at "highest" (no TF32 on a card) while the process allows
    "high", which comes back after them; the triangle is made once."""

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm):
                self.seen.append(torch.get_float32_matmul_precision())
            return func(*args, **(kwargs or {}))

    raw4, z, rd, noise = _planes(2, R=4, S=8)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        r4 = _t(raw4).requires_grad_(True)
        with Products() as mode:
            o = tcomp.raw2outputs_planes(r4, _t(z), _t(rd), noise=_t(noise), matmul_scan=True)
            o.rgb.sum().backward()
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(saved)
    assert mode.seen == ["highest", "highest"] and after == "high"
    U = tcomp.strict_upper_ones(8, "cpu")
    assert U is tcomp.strict_upper_ones(8, torch.device("cpu"))
    assert torch.equal(U, torch.triu(torch.ones(8, 8), 1))


@pytest.mark.parametrize("dtype,fused,want", [("bfloat16", True, [True, True]),
                                              ("float32", True, [False, False]),
                                              ("bfloat16", False, [])])
def test_renderer_scans_by_matmul_in_bf16(monkeypatch, dtype, fused, want):
    """``render_rays``' planes branch (K1/K4, here their plain versions on
    the CPU) composites with the matmul scan in bf16 and the exact cumprod
    in f32, on both levels (nerf_tpu/render/renderer.py:159); the points-in
    branch has no planes call."""
    seen = []
    real = renderer.raw2outputs_planes

    def spy(*args, matmul_scan=False, **kwargs):
        seen.append(matmul_scan)
        return real(*args, matmul_scan=matmul_scan, **kwargs)

    monkeypatch.setattr(renderer, "raw2outputs_planes", spy)
    cfg = MLPConfig(width=128)
    model = NeRFModel(PosEncConfig(10), PosEncConfig(4), cfg, cfg, dtype, fused=fused)
    nets = {lvl: NeRFMLP(cfg, seed=s, device="cpu") for s, lvl in enumerate(("coarse", "fine"))}
    rs = renderer.RenderSettings(n_samples=8, n_importance=8, perturb=False)
    rng = np.random.default_rng(4)
    ro, rd = (_t(rng.standard_normal((3, 3)).astype(np.float32)) for _ in range(2))
    out = renderer.render_rays(nets, model, rs, ro, rd, rd / rd.norm(dim=-1, keepdim=True),
                               torch.full((3,), 2.0), torch.full((3,), 6.0))
    assert seen == want
    assert bool(torch.isfinite(out["rgb_map"]).all())
