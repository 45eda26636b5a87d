"""The port's fused-render path (K5 forward, K6 backward) against nerf_tpu,
on the CPU.

The same numpy inputs go through ``nerf_tpu.experimental.fused_render``
(its Pallas kernels K5/K6 in interpret mode, as tests/test_fused_render.py
runs them) and the port's ``experimental/fused_render.py``, which takes the
kernels' plain versions on a CPU tensor: one level's maps in f32 and bf16,
with and without a white background and sigma noise; the weight grads of a
loss on all four maps; an empty ray; ``render_rays`` with ``fused_render``
(and its dispatch at S % 8 != 0 and with retraw); two train steps; and the
wrappers, which never fall back to the plain version on the CUDA path. The
CUDA kernels are checked on the card by tests/test_torch_port_kernels.py
and chip_smoke.py.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.experimental import fused_render as jfr
from nerf_tpu.models.embedding import PosEncConfig as JPosEnc
from nerf_tpu.models.nerf_mlp import MLPConfig as JMLPConfig
from nerf_tpu.models.nerf_mlp import init_params
from nerf_tpu.render import renderer as jr
from nerf_tpu.render.network import NeRFModel as JNeRFModel
from nerf_tpu.train import step as jstep
from nerf_tpu_torch.experimental import fused_render as tfr
from nerf_tpu_torch.models.convert import jax_params_from_state_dict, state_dict_from_jax_params
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import _build, fused_mlp
from nerf_tpu_torch.render import renderer as tr
from nerf_tpu_torch.render.network import NeRFModel
from nerf_tpu_torch.train import step as tstep
from test_torch_port_train import _min_preactivation

W = 128  # the fused kernels need a multiple of 128
R, S = 24, 16  # rays, and samples of one level
CFG, JCFG = MLPConfig(width=W), JMLPConfig(width=W)
PE_P, PE_V = PosEncConfig(10), PosEncConfig(4)
JPE_P, JPE_V = JPosEnc(10), JPosEnc(4)
# f32 maps: nerf_tpu's own bound for this kernel against its jnp path
# (tests/test_fused_render.py:57-64), disp where finite in both.
F32_RTOL, F32_ATOL = 2e-5, 2e-6
# bf16 maps against nerf_tpu's bf16 kernel: both round the same operands,
# but nerf_tpu's bf16 posenc is a polynomial (max error 1.8e-5) and the
# sums run in another order, so raw differs by up to ~1e-3
# (tests/test_torch_port_points.py: BF16_FWD_TOL 2e-3); the maps are
# weighted means of sigmoid(raw) and of z, with alpha = 1 - exp(-σ·dist),
# so they move by about as much. Measured here: up to 2.9e-4 (depth, ~4 in
# size), rgb 7.0e-5; disp relative 6.7e-5.
BF16_ATOL = 2e-3
# Weight grads: nerf_tpu's own bound for the fused render against its jnp
# path (tests/test_fused_render.py:90-93); bf16 per-leaf relative L2, its
# bf16 grad bound (tests/test_fused_mlp.py:175-183). Measured here: f32
# |got - want| <= 2.2e-5 (atol/rtol + |want|), bf16 up to 1.6e-2 (trunk 0).
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6
BF16_GRAD_TOL = 0.05
LRATE, LRATE_DECAY = 5e-4, 500


def _jparams(seed):
    return jax.tree.map(np.asarray, init_params(jax.random.key(seed), JCFG))


def _port_net(params):
    net = NeRFMLP(CFG, device="cpu")
    net.load_state_dict(state_dict_from_jax_params(params, CFG), strict=True)
    return net


def _leaf_pairs(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree.leaves(b)
    assert len(la) == len(lb)
    return [(jax.tree_util.keystr(p), np.asarray(x), np.asarray(y)) for (p, x), y in zip(la, lb)]


def _inputs(seed, n=R, n_samples=S):
    """Rays from near the origin (tests/test_fused_render.py's), depths in
    [2, 6], sigma noise of std 0.5."""
    rng = np.random.default_rng(seed)
    ro = (rng.standard_normal((n, 3)) * 0.1).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (n, n_samples)).astype(np.float32), -1)
    noise = (rng.standard_normal((n, n_samples)) * 0.5).astype(np.float32)
    return ro, rd, vd, z, noise, rng


def _conditioned_inputs(net, margin=2e-6):
    """Inputs whose relu inputs all lie further than ``margin`` from zero:
    the two packages' f32 forwards differ by ~1e-6, and at init one relu that
    switches in one package only moves the first trunk layers' small,
    cancelling grads by up to ~7% (ROADMAP C)."""
    for seed in range(100):
        ins = _inputs(500 + seed)
        if _min_preactivation(net, *ins[:4]) > margin:
            return ins
    raise AssertionError("no well-conditioned inputs in 100 seeds")


def _jax_level(params, ro, rd, vd, z, noise, white, dtype):
    return jfr.fused_render_level(params, JCFG, JPE_P, JPE_V,
                                  *(jnp.asarray(a) for a in (ro, rd, vd, z)),
                                  None if noise is None else jnp.asarray(noise), white,
                                  compute_dtype=getattr(jnp, dtype))


def _port_level(net, ro, rd, vd, z, noise, white, dtype):
    return tfr.fused_render_level(net, CFG, PE_P, PE_V,
                                  *(torch.from_numpy(a) for a in (ro, rd, vd, z)),
                                  None if noise is None else torch.from_numpy(noise), white,
                                  compute_dtype=getattr(torch, dtype))


# (a) one level's maps: K5's plain version against nerf_tpu's K5


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("with_noise", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_maps_match_jax(white, with_noise, dtype):
    params = _jparams(3)
    net = _port_net(params)
    ro, rd, vd, z, noise, _ = _inputs(3)
    noise = noise if with_noise else None
    ref = _jax_level(params, ro, rd, vd, z, noise, white, dtype)
    before = tfr.fused_render_fwd.launches
    with torch.no_grad():
        out = _port_level(net, ro, rd, vd, z, noise, white, dtype)
    assert tfr.fused_render_fwd.launches == before  # CPU: the plain version
    if with_noise:  # noise below -σ on a last sample leaves its ray partly empty
        assert float(out.acc.min()) < 0.9 < float(out.acc.max())
    for name in ("rgb", "acc", "weights", "depth", "disp"):
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        finite = np.isfinite(got) & np.isfinite(want)
        assert (np.isfinite(got) == np.isfinite(want)).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(got[finite], want[finite], rtol=F32_RTOL, atol=F32_ATOL,
                                       err_msg=name)
        elif name != "disp":  # disp = 1/(depth/acc): relative
            assert np.abs(got - want).max() <= BF16_ATOL, (name, np.abs(got - want).max())
        else:
            np.testing.assert_allclose(got[finite], want[finite], rtol=BF16_ATOL, err_msg=name)


# (b) weight grads of a loss on every map: K6's plain version against
# jax.grad through nerf_tpu's custom VJP


def _map_loss(rgb, disp, acc, w, coef, target, xp):
    """One-signed weights on every map (a random, zero-mean cotangent makes
    grads that nearly cancel); disp only where finite (an empty ray's is
    NaN, and its cotangent is then zero)."""
    disp = xp.where(xp.isfinite(disp), disp, 0.0)
    return (((rgb - target) ** 2).mean() + coef[0] * disp.mean() + coef[1] * acc.mean()
            + coef[2] * (w * coef[3]).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_grads_match_jax(dtype):
    params = _jparams(7)
    net = _port_net(params)
    ro, rd, vd, z, noise, rng = _conditioned_inputs(net)
    target = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    coef = (0.3, 0.5, 0.7, rng.uniform(0.5, 1.5, (R, S)).astype(np.float32))

    def jloss(p):
        o = _jax_level(p, ro, rd, vd, z, noise, True, dtype)
        return _map_loss(o.rgb, o.disp, o.acc, o.weights, coef, target, jnp)

    ref = jax.jit(jax.grad(jloss))(params)
    before = tfr.fused_render_bwd.launches
    o = _port_level(net, ro, rd, vd, z, noise, True, dtype)
    _map_loss(o.rgb, o.disp, o.acc, o.weights, [torch.as_tensor(c) for c in coef],
              torch.from_numpy(target), torch).backward()
    assert tfr.fused_render_bwd.launches == before  # CPU: the plain version
    grads = jax_params_from_state_dict({n: p.grad for n, p in net.named_parameters()}, CFG)
    for name, got, want in _leaf_pairs(grads, ref):
        assert got.shape == want.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
        else:
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= BF16_GRAD_TOL, (name, err)


def test_empty_ray_grads_finite_and_match_jax():
    """Noise of -1e4 empties a ray (acc = 0, disp = NaN): the ``live``
    guard keeps its NaN out of the grads, as in nerf_tpu."""
    params = _jparams(7)
    net = _port_net(params)
    ro, rd, vd, z, noise, rng = _conditioned_inputs(net)
    noise[0] = -1e4
    target = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    coef = (0.3, 0.5, 0.7, np.ones((R, S), np.float32))

    def jloss(p):
        o = _jax_level(p, ro, rd, vd, z, noise, True, "float32")
        return _map_loss(o.rgb, o.disp, o.acc, o.weights, coef, target, jnp)

    ref = jax.jit(jax.grad(jloss))(params)
    o = _port_level(net, ro, rd, vd, z, noise, True, "float32")
    assert float(o.acc[0].detach()) == 0.0 and bool(torch.isnan(o.disp[0].detach()))
    _map_loss(o.rgb, o.disp, o.acc, o.weights, [torch.as_tensor(c) for c in coef],
              torch.from_numpy(target), torch).backward()
    grads = jax_params_from_state_dict({n: p.grad for n, p in net.named_parameters()}, CFG)
    for name, got, want in _leaf_pairs(grads, ref):
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("white", [False, True])
def test_plain_backward_equals_autograd_f32(white):
    """In f32 K6's plain version is autograd through K5's: the compositing
    backward's hand formulas and K4's plain backward, for cotangents on all
    four maps."""
    net = NeRFMLP(CFG, seed=5, device="cpu")
    ro, rd, vd, z, noise, rng = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                 for a in _inputs(5))
    g_rgb, g_disp, g_acc, g_w = (torch.from_numpy(rng.uniform(0.5, 1.5, s).astype(np.float32))
                                 for s in ((R, 3), (R,), (R,), (R, S)))
    with torch.no_grad():
        kp = fused_mlp.pack_params(net, PE_P, PE_V, torch.float32)
        raw = tfr.fused_render_fwd(kp, ro, rd, vd, z, noise, white, keep_raw=True).raw
        grads = tfr.fused_render_bwd(kp, ro, rd, vd, z, noise, raw, g_rgb, g_disp, g_acc, g_w,
                                     white)
    leaves = {k: t.detach().clone().requires_grad_(True) for k, t in kp.items()}
    m = tfr.fused_render_reference(leaves, ro, rd, vd, z, noise, white)
    ((m.rgb * g_rgb).sum() + (m.disp * g_disp).sum() + (m.acc * g_acc).sum()
     + (m.w * g_w).sum()).backward()
    for name in fused_mlp.KP_NAMES:
        want = leaves[name].grad
        err = float((grads[name] - want).abs().max() / want.abs().max())
        assert err <= 1e-5, (name, err)


# (c) render_rays and train steps


def _models(**kw):
    return (JNeRFModel(JPE_P, JPE_V, JCFG, JCFG, "float32", fused=True, fused_render=True, **kw),
            NeRFModel(PE_P, PE_V, CFG, CFG, "float32", fused=True, fused_render=True, **kw))


def _overrides(rng, n_samples, n_importance, noise=True):
    ov = {"t_rand": rng.uniform(size=(R, n_samples)).astype(np.float32),
          "u": rng.uniform(size=(R, n_importance)).astype(np.float32)}
    if noise:
        ov["noise0"] = (rng.standard_normal((R, n_samples)) * 0.3).astype(np.float32)
        ov["noise1"] = (rng.standard_normal((R, n_samples + n_importance)) * 0.3).astype(np.float32)
    return ov


@pytest.mark.parametrize("n_samples,retraw", [(16, False), (13, False), (16, True)])
def test_render_rays_matches_jax(n_samples, retraw, monkeypatch):
    """At 16+16 both levels take K5 as in nerf_tpu; at 13+8 (S = 13 and
    21) the same model takes the points-in query (K2), and with retraw the
    split raygen path (K1), as nerf_tpu's dispatch does."""
    n_importance = 16 if n_samples == 16 else 8
    jmodel, tmodel = _models()
    kw = dict(n_samples=n_samples, n_importance=n_importance, white_bkgd=True,
              raw_noise_std=0.3, retraw=retraw)
    jrs, trs = jr.RenderSettings(**kw), tr.RenderSettings(**kw)
    params = {"coarse": _jparams(0), "fine": _jparams(1)}
    nets = {k: _port_net(v) for k, v in params.items()}
    ro, rd, vd, _, _, rng = _inputs(11)
    near, far = np.full(R, 2.0, np.float32), np.full(R, 6.0, np.float32)
    ov = _overrides(rng, n_samples, n_importance)
    ref = jr.render_rays(params, jmodel, jrs, *(jnp.asarray(a) for a in (ro, rd, vd, near, far)),
                         overrides={k: jnp.asarray(v) for k, v in ov.items()})
    calls = []
    for mod, name in ((tfr, "fused_render_level"), (fused_mlp, "fused_query_rays_planes"),
                      (fused_mlp, "fused_query")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    with torch.no_grad():
        out = tr.render_rays(nets, tmodel, trs, *(torch.from_numpy(a) for a in (ro, rd, vd, near, far)),
                             overrides={k: torch.from_numpy(v) for k, v in ov.items()})
    want = {16: "fused_render_level", 13: "fused_query"}[n_samples]
    if retraw:
        want = "fused_query_rays_planes"
    assert calls == [want, want]  # one query per level
    assert set(out) == set(ref)
    for k in out:
        got, exp = out[k].numpy(), np.asarray(ref[k])
        finite = np.isfinite(got) & np.isfinite(exp)
        assert (np.isfinite(got) == np.isfinite(exp)).all(), k
        # the fine level follows the coarse weights' CDF (ROADMAP C): raw at
        # the fine depths may move by ~1e-4, the maps by ~1e-5
        atol = 1e-4 if k == "raw" else 1e-5
        np.testing.assert_allclose(got[finite], exp[finite], rtol=1e-4, atol=atol, err_msg=k)


def test_train_steps_match_jax():
    """Two train steps at 16+16 with sigma noise, both levels through K5/K6."""
    n_samples, n_importance = 16, 16
    jmodel, tmodel = _models()
    kw = dict(n_samples=n_samples, n_importance=n_importance, white_bkgd=True, raw_noise_std=0.3)
    jrs, trs = jr.RenderSettings(**kw), tr.RenderSettings(**kw)
    params = {"coarse": _jparams(0), "fine": _jparams(1)}
    core = jax.jit(jstep.make_train_step_core(jmodel, jrs, LRATE, LRATE_DECAY))
    jstate = jstep.init_train_state(params, LRATE, LRATE_DECAY)
    state = tstep.init_train_state({k: _port_net(v) for k, v in params.items()}, LRATE)
    step = tstep.make_train_step(tmodel, trs, LRATE, LRATE_DECAY)
    for i in range(2):
        ro, rd, _, _, _, rng = _inputs(20 + i)
        target = rng.uniform(0, 1, (R, 3)).astype(np.float32)
        near, far = np.full(R, 2.0, np.float32), np.full(R, 6.0, np.float32)
        ov = _overrides(rng, n_samples, n_importance)
        jstate, jaux = core(jstate, *(jnp.asarray(a) for a in (ro, rd, near, far, target)),
                            {k: jnp.asarray(v) for k, v in ov.items()})
        aux = step(state, *(torch.from_numpy(a) for a in (ro, rd, near, far, target)),
                   overrides={k: torch.from_numpy(v) for k, v in ov.items()})
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    got = {k: jax_params_from_state_dict(net.state_dict(), CFG) for k, net in state.nets.items()}
    # as tests/test_torch_port_train.py::test_train_steps_match_jax: Adam's
    # first updates are lr * sign(g), so small grad differences of the first
    # trunk layers move their updates most; a wrong update is off by order 1
    for (name, g, want), (_, p0, _) in zip(
        _leaf_pairs(got, jstate.params), _leaf_pairs(params, jstate.params)
    ):
        assert np.abs(g - want).max() <= 4 * LRATE, name
        err = np.linalg.norm((g - p0) - (want - p0)) / np.linalg.norm(want - p0)
        assert err <= 5e-2, (name, err)


# (d) the wrappers


def test_wrappers_on_cpu():
    """On a CPU tensor K5's and K6's wrappers and K6's compositing pass run
    their plain versions (the counters stay), K5's raw is K1's plain
    version, and inputs are checked."""
    net = NeRFMLP(CFG, seed=4, device="cpu")
    kp = fused_mlp.pack_params(net, PE_P, PE_V, torch.bfloat16)
    ro, rd, vd, z, noise, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                               for a in _inputs(4, n=5))
    counts = (tfr.fused_render_fwd.launches, tfr.fused_render_bwd.launches,
              tfr.composite_bwd.launches)
    with torch.no_grad():
        m = tfr.fused_render_fwd(kp, ro, rd, vd, z, noise, True, keep_raw=True)
        assert torch.equal(m.raw, fused_mlp.fused_rays_planes_reference(kp, ro, rd, vd, z))
        assert tfr.fused_render_fwd(kp, ro, rd, vd, z, noise, True).raw is None
        g = (torch.ones(5, 3), torch.ones(5), torch.ones(5), torch.ones(5, S))
        grads = tfr.fused_render_bwd(kp, ro, rd, vd, z, None, m.raw, *g, False)
        planes = tfr.composite_bwd(m.raw, rd, z, noise, *g, True)
        assert torch.equal(planes, tfr.composite_bwd_reference(m.raw, rd, z, noise, *g, True))
    assert set(grads) == set(fused_mlp.KP_NAMES)
    assert (tfr.fused_render_fwd.launches, tfr.fused_render_bwd.launches,
            tfr.composite_bwd.launches) == counts
    with pytest.raises(ValueError, match="noise"):
        tfr.fused_render_fwd(kp, ro, rd, vd, z, noise[:, :8], True)
    with pytest.raises(ValueError, match="g_w"):
        tfr.fused_render_bwd(kp, ro, rd, vd, z, noise, m.raw, *g[:3], g[3][:, :8], True)
    with pytest.raises(ValueError, match="raw"):
        tfr.composite_bwd(m.raw[:3], rd, z, noise, *g, True)
    with pytest.raises(ValueError, match="device"):
        tfr.fused_render_fwd(kp, *(t.to("meta") for t in (ro, rd, vd, z)), None, True)
    assert tfr.supports(CFG, PE_P, PE_V, 64) and not tfr.supports(CFG, PE_P, PE_V, 63)


def _fake_cuda(monkeypatch):
    """Let the CUDA launch path run on CPU tensors up to its C call: the
    device context, stream and properties (an H100's 132 SMs, which size
    K5's slab) of torch.cuda become stand-ins."""
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev=None: types.SimpleNamespace(multi_processor_count=132))


@pytest.mark.parametrize("n_samples,groups", [(8, (16, 1)), (64, (2, 1)), (192, (2, 3)),
                                              (200, (16, 25))])
def test_ray_groups_and_slab(n_samples, groups):
    """K5's bf16 geometry (csrc/fused_render.cu ray_groups): G whole rays
    fill n_sub 128-point tiles; the slab holds, for each CTA of the
    persistent grid of min(groups, SMs), two buffers of a group's 4 raw
    planes."""
    assert tfr.ray_groups(n_samples) == groups
    G, n_sub = groups
    assert G * n_samples == n_sub * fused_mlp.FWD_TILE
    group = 2 * 4 * G * n_samples
    assert tfr.slab_floats(32768, n_samples, 132) == 132 * group  # a serving chunk
    assert tfr.slab_floats(1, n_samples, 132) == group
    assert tfr.slab_floats(5 * G + 1, n_samples, 132) == 6 * group  # a ragged last group


@pytest.mark.parametrize("failure", ["build", "error_code"])
def test_cuda_path_failure_raises_without_fallback(failure, monkeypatch):
    """A build that fails or a launch that returns an error raises from K5
    and K6; neither falls back to its plain version."""
    net = NeRFMLP(CFG, seed=6, device="cpu")
    kp = fused_mlp.pack_params(net, PE_P, PE_V, torch.bfloat16)
    ro, rd, vd, z, noise, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                               for a in _inputs(6, n=5))
    g = (torch.ones(5, 3), torch.ones(5), torch.ones(5), torch.ones(5, S))
    raw = torch.zeros(4, 5, S)
    _fake_cuda(monkeypatch)

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    for name in ("fused_render_reference", "fused_render_bwd_reference",
                 "composite_bwd_reference"):
        monkeypatch.setattr(tfr, name, no_plain)
    if failure == "build":
        def load(name):
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu")
        match = "nvcc failed"
    else:
        lib = types.SimpleNamespace(
            nerf_fused_render_fwd=lambda *a: 2, nerf_fused_render_bwd_planes=lambda *a: 2,
            nerf_cuda_error_string=lambda err: b"out of memory")
        load = lambda name: lib  # noqa: E731
        match = "out of memory"
    monkeypatch.setattr(_build, "load", load)
    counts = (tfr.fused_render_fwd.launches, tfr.fused_render_bwd.launches,
              tfr.composite_bwd.launches)
    with pytest.raises(RuntimeError, match=match):
        tfr._launch_fwd(kp, ro, rd, vd, z, noise, True, None, False)
    with pytest.raises(RuntimeError, match=match):
        tfr._launch_bwd(kp, ro, rd, vd, z, noise, raw, *g, True, None)
    with pytest.raises(RuntimeError, match=match):
        tfr._launch_composite_bwd(raw, rd, z, noise, *g, True)
    assert (tfr.fused_render_fwd.launches, tfr.fused_render_bwd.launches,
            tfr.composite_bwd.launches) == counts


# (e) the wide family's configurations (ROADMAP C.3): K5w / K6w's plain
# versions, which the CPU wrappers run, against nerf_tpu's K5 / K6


@pytest.mark.parametrize("config", ["W384-10-4", "W128-16-6"])
def test_wide_level_maps_and_grads_match_jax(config):
    """One level at a width or octave count the W <= 256 tile is not built
    for (nerf_tpu's Pallas K5 / K6 in interpret mode): the maps within its
    own f32 bound and the weight grads of a loss on all four maps within
    test_level_grads_match_jax's, on rays whose points both packages compute
    alike (tests/test_torch_port_fused_mlp.py::_wide_rays)."""
    from test_torch_port_fused_mlp import WIDE, _wide_nets, _wide_rays

    width, fp, fv = WIDE[config]
    params, net, (jcfg, jpp, jpv), (cfg, pp, pv) = _wide_nets(width, fp, fv, seed=5)
    n, s = 4, 8
    ro, rd, vd, z = _wide_rays(net, (cfg, pp, pv), n, s)
    rng = np.random.default_rng(width + fp)
    noise = (rng.standard_normal((n, s)) * 0.5).astype(np.float32)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    coef = (0.3, 0.5, 0.7, rng.uniform(0.5, 1.5, (n, s)).astype(np.float32))

    def jloss(p):
        o = jfr.fused_render_level(p, jcfg, jpp, jpv, *(jnp.asarray(a) for a in (ro, rd, vd, z)),
                                   jnp.asarray(noise), True, compute_dtype=jnp.float32)
        return _map_loss(o.rgb, o.disp, o.acc, o.weights, coef, target, jnp), o

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    before = (tfr.fused_render_fwd.launches, tfr.fused_render_wide_fwd.launches,
              tfr.fused_render_bwd.launches, tfr.fused_render_wide_bwd.launches)
    o = tfr.fused_render_level(net, cfg, pp, pv, *(torch.from_numpy(a) for a in (ro, rd, vd, z)),
                               torch.from_numpy(noise), True, compute_dtype=torch.float32)
    _map_loss(o.rgb, o.disp, o.acc, o.weights, [torch.as_tensor(c) for c in coef],
              torch.from_numpy(target), torch).backward()
    assert before == (tfr.fused_render_fwd.launches, tfr.fused_render_wide_fwd.launches,
                      tfr.fused_render_bwd.launches, tfr.fused_render_wide_bwd.launches)
    for got, want in ((o.rgb, ref.rgb), (o.disp, ref.disp), (o.acc, ref.acc),
                      (o.weights, ref.weights)):
        got, want = got.detach().numpy(), np.asarray(want)
        finite = np.isfinite(want)
        assert (np.isfinite(got) == finite).all()
        np.testing.assert_allclose(got[finite], want[finite], rtol=F32_RTOL, atol=F32_ATOL)
    grads = jax_params_from_state_dict({k: p.grad for k, p in net.named_parameters()}, cfg)
    for name, got, want in _leaf_pairs(grads, jgrads):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("failure", ["build", "error_code"])
def test_wide_cuda_path_failure_raises_without_fallback(failure, monkeypatch):
    """At a wide configuration (W = 384) a build that fails or a launch that
    returns an error raises from K1w, K4w, K5w and K6w; none falls back to
    a plain version, and no counter moves."""
    from nerf_tpu_torch.ops import fused_mlp_wide

    net = NeRFMLP(MLPConfig(width=384), seed=6, device="cpu")
    kp = fused_mlp.pack_params(net, PE_P, PE_V, torch.bfloat16)
    assert fused_mlp.is_wide(kp)
    ro, rd, vd, z, noise, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                               for a in _inputs(6, n=5))
    g = (torch.ones(5, 3), torch.ones(5), torch.ones(5), torch.ones(5, S))
    raw = torch.zeros(4, 5, S)
    _fake_cuda(monkeypatch)

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    for mod, name in ((tfr, "fused_render_reference"), (tfr, "fused_render_bwd_reference"),
                      (fused_mlp, "fused_rays_planes_reference"),
                      (fused_mlp, "fused_rays_planes_bwd_reference")):
        monkeypatch.setattr(mod, name, no_plain)
    if failure == "build":
        def load(name):
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu")
        match = "nvcc failed"
    else:
        lib = types.SimpleNamespace(nerf_wide_embed=lambda *a: 2,
                                    nerf_fused_render_bwd_planes=lambda *a: 2,
                                    nerf_cuda_error_string=lambda err: b"out of memory")
        load = lambda name: lib  # noqa: E731
        match = "out of memory"
    monkeypatch.setattr(_build, "load", load)
    counters = (fused_mlp_wide.fused_rays_planes_wide, fused_mlp_wide.fused_rays_planes_wide_bwd,
                tfr.fused_render_wide_fwd, tfr.fused_render_wide_bwd)
    counts = [c.launches for c in counters]
    with pytest.raises(RuntimeError, match=match):
        fused_mlp_wide.fused_rays_planes_wide(kp, ro, rd, vd, z)
    with pytest.raises(RuntimeError, match=match):
        fused_mlp_wide.fused_rays_planes_wide_bwd(kp, ro, rd, vd, z, raw)
    with pytest.raises(RuntimeError, match=match):
        tfr._launch_fwd(kp, ro, rd, vd, z, noise, True, None, False)
    with pytest.raises(RuntimeError, match=match):
        tfr._launch_bwd(kp, ro, rd, vd, z, noise, raw, *g, True, None)
    assert [c.launches for c in counters] == counts
