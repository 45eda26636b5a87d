"""The port's points-in path (K2 forward, K3 backward) against nerf_tpu, on
the CPU.

The same numpy inputs go through ``nerf_tpu.ops.fused_mlp.fused_query``
(its Pallas kernels K2/K3 in interpret mode, as tests/test_fused_mlp.py runs
them) and the port's ``fused_query``, which takes the kernels' plain
versions on a CPU tensor: the forward in both view modes (a direction per
point when S % 8 != 0, per ray when S % 8 == 0) and at a ragged point
count, the weight grads, dx and dv through the posenc trig, the
``input_grads=False`` mode, ``query_raw`` and whole train steps at sample
counts that are not multiples of 8. The CUDA kernels are checked on the
card by tests/test_torch_port_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.embedding import PosEncConfig as JPosEnc
from nerf_tpu.models.embedding import posenc
from nerf_tpu.models.nerf_mlp import MLPConfig as JMLPConfig
from nerf_tpu.models.nerf_mlp import apply_mlp, init_params
from nerf_tpu.ops import fused_mlp as jfused
from nerf_tpu.render import network as jnetwork
from nerf_tpu.render import renderer as jr
from nerf_tpu.render.network import NeRFModel as JNeRFModel
from nerf_tpu.train import step as jstep
from nerf_tpu_torch.models.convert import jax_params_from_state_dict, state_dict_from_jax_params
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import fused_mlp
from nerf_tpu_torch.render import network as tnetwork
from nerf_tpu_torch.render import renderer as tr
from nerf_tpu_torch.render.network import NeRFModel
from nerf_tpu_torch.train import step as tstep

W = 128  # the fused kernels need a multiple of 128
R = 13  # a ragged ray count
# S = 13: a direction per point (spr = 1, the renderer's mode at S % 8 != 0);
# S = 16: a direction per ray (spr = S, fused_query's mode at S % 8 == 0)
SPR_CASES = (13, 16)
CFG, JCFG = MLPConfig(width=W), JMLPConfig(width=W)
PE_P, PE_V = PosEncConfig(10), PosEncConfig(4)
JPE_P, JPE_V = JPosEnc(10), JPosEnc(4)
F32_TOL = 1e-5  # forward, tests/test_fused_mlp.py:52-68
# bf16 forward against nerf_tpu's bf16 kernel: the operand rounding is the
# same, but nerf_tpu's bf16 posenc is a polynomial (max error 1.8e-5) and the
# sums run in another order (tests/test_torch_port_fused_mlp.py, raygen mode).
BF16_FWD_TOL = 2e-3
# f32 weight grads, relative to each leaf's largest entry: against jax.grad
# through nerf_tpu's plain MLP 1e-5; against its Pallas K3, which itself lies
# up to ~2e-5 from that plain autodiff (its sin/cos and sums differ), 5e-5
# (the bounds of tests/test_torch_port_train.py:62-68).
F32_GRAD_TOL = 1e-5
F32_PALLAS_GRAD_TOL = 5e-5
# bf16 grads (weights and inputs), per-tensor relative L2: nerf_tpu's own
# bound for its bf16 grads (tests/test_fused_mlp.py:175-183).
BF16_GRAD_TOL = 0.05
# f32 dx and dv, relative to the largest entry: nerf_tpu's f32 gradient
# bound (rtol 1e-5). Measured here up to 2.9e-7 (dx at S = 16); bf16 dx and
# dv measured up to 3.3e-3 relative L2 (dx at S = 16).
F32_INPUT_GRAD_TOL = 1e-5
LOSS_GRAD_TOL = 1e-2  # tests/test_torch_port_train.py: through the whole render
UPDATE_TOL = 5e-2  # tests/test_torch_port_train.py: two Adam steps' update
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


def _grads_as_jax(net):
    return jax_params_from_state_dict({n: p.grad for n, p in net.named_parameters()}, CFG)


def _points(seed, n_rays, S):
    """Points on rays [n, S, 3] and unit directions [n, 3]."""
    rng = np.random.default_rng(seed)
    ro = (rng.standard_normal((n_rays, 3)) * 0.3).astype(np.float32)
    rd = rng.standard_normal((n_rays, 3)).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (n_rays, S)).astype(np.float32), -1)
    return (ro[:, None] + rd[:, None] * z[..., None]).astype(np.float32), vd, rng


def _min_preactivation(net, pts, vd):
    """Smallest |input| of any relu of the fused MLP's trunk and view layer."""
    with torch.no_grad():
        kp = fused_mlp.pack_params(net, PE_P, PE_V, torch.float32)
        S = pts.shape[1]
        e = fused_mlp._embed(torch.from_numpy(pts).reshape(-1, 3), PE_P.num_freqs)
        z05 = e @ kp["W05e"]
        pre = [z05[:, :W] + kp["b0"]]
        for i in range(1, 8):
            zi = torch.relu(pre[-1]) @ kp[f"W{i}"] + kp[f"b{i}"]
            pre.append(zi + z05[:, W:] if i == 5 else zi)
        feat = torch.relu(pre[-1]) @ kp["Wf"] + kp["bf"]
        ev = fused_mlp._embed(torch.from_numpy(vd), PE_V.num_freqs) @ kp["Wve"]
        pre.append(feat @ kp["Wvf"] + ev.repeat_interleave(S, 0) + kp["bv"])
        return min(float(t.abs().min()) for t in pre)


def _conditioned_points(net, S, margin=2e-6):
    """Inputs whose relu inputs all lie further than ``margin`` from zero:
    the two packages' f32 forwards differ by ~1e-6, and at init one relu
    that switches in one package only moves the first trunk layers' small,
    cancelling grads by up to ~7% (ROADMAP C)."""
    for seed in range(100):
        pts, vd, rng = _points(1000 * S + seed, R, S)
        if _min_preactivation(net, pts, vd) > margin:
            return pts, vd, rng
    raise AssertionError("no well-conditioned inputs in 100 seeds")


def _port_query(net, pts, vd, dtype, input_grads=True):
    return fused_mlp.fused_query(net, CFG, PE_P, PE_V, pts, vd,
                                 compute_dtype=getattr(torch, dtype), input_grads=input_grads)


def _jax_query(params, pts, vd, dtype, input_grads=True):
    return jfused.fused_query(params, JCFG, JPE_P, JPE_V, pts, vd,
                              compute_dtype=getattr(jnp, dtype), input_grads=input_grads)


def _rel_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (a) forward: K2's plain version against nerf_tpu's K2


@pytest.mark.parametrize("n_rays,S", [(R, 13), (R, 16), (3, 77)])  # 3x77: 231 points, ragged
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(n_rays, S, dtype):
    params = _jparams(S)
    net = _port_net(params)
    pts, vd, _ = _points(S, n_rays, S)
    ref = np.asarray(_jax_query(params, jnp.asarray(pts), jnp.asarray(vd), dtype))
    before = fused_mlp.fused_points.launches
    with torch.no_grad():
        out = _port_query(net, torch.from_numpy(pts), torch.from_numpy(vd), dtype).numpy()
    assert fused_mlp.fused_points.launches == before  # CPU: the plain version
    assert out.shape == ref.shape == (n_rays, S, 4) and out.dtype == np.float32
    err = float(np.abs(out - ref).max())
    assert err <= (F32_TOL if dtype == "float32" else BF16_FWD_TOL), err


# (b) weight grads: K3's plain version against jax.grad through nerf_tpu's K3


@pytest.mark.parametrize("S", SPR_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_grads_match_jax(S, dtype):
    params = _jparams(100 + S)
    net = _port_net(params)
    pts, vd, rng = _conditioned_points(net, S)
    target = rng.uniform(-1, 1, (R, S, 4)).astype(np.float32)

    def jloss(p):
        out = _jax_query(p, jnp.asarray(pts), jnp.asarray(vd), dtype)
        return jnp.mean((out - target) ** 2)

    def jplain(p):
        v = np.broadcast_to(vd[:, None], (R, S, 3)).reshape(-1, 3)
        raw = apply_mlp(p, JCFG, posenc(jnp.asarray(pts).reshape(-1, 3), JPE_P),
                        posenc(jnp.asarray(v), JPE_V))
        return jnp.mean((raw.reshape(R, S, 4) - target) ** 2)

    ref = jax.jit(jax.grad(jloss))(params)
    before = fused_mlp.fused_points_bwd.launches
    out = _port_query(net, torch.from_numpy(pts), torch.from_numpy(vd), dtype)
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    assert fused_mlp.fused_points_bwd.launches == before  # CPU: the plain version
    grads = _grads_as_jax(net)
    for name, got, want in _leaf_pairs(grads, ref):
        assert got.shape == want.shape, name
        if dtype == "float32":
            assert _rel_max(got, want) <= F32_PALLAS_GRAD_TOL, (name, _rel_max(got, want))
        else:
            assert _rel_l2(got, want) <= BF16_GRAD_TOL, (name, _rel_l2(got, want))
    if dtype == "float32" and S == 13:  # once: eager JAX autodiff is slow
        with jax.default_matmul_precision("highest"):
            plain = jax.grad(jplain)(params)  # eager: jit fuses the f32 math differently
        for name, got, want in _leaf_pairs(grads, plain):
            assert _rel_max(got, want) <= F32_GRAD_TOL, (name, _rel_max(got, want))


# (c) dx and dv through the posenc trig


@pytest.mark.parametrize("S", SPR_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_input_grads_match_jax(S, dtype):
    params = _jparams(200 + S)
    net = _port_net(params)
    pts, vd, rng = _conditioned_points(net, S)
    target = rng.uniform(-1, 1, (R, S, 4)).astype(np.float32)

    def jloss(p_, d_):
        return jnp.mean((_jax_query(params, p_, d_, dtype) - target) ** 2)

    jdx, jdv = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(pts), jnp.asarray(vd))
    p_t = torch.from_numpy(pts).requires_grad_(True)
    v_t = torch.from_numpy(vd).requires_grad_(True)
    out = _port_query(net, p_t, v_t, dtype)
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    for name, got, want in (("dx", p_t.grad, jdx), ("dv", v_t.grad, jdv)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape, name
        if dtype == "float32":
            assert _rel_max(got, want) <= F32_INPUT_GRAD_TOL, (name, _rel_max(got, want))
        else:
            assert _rel_l2(got, want) <= BF16_GRAD_TOL, (name, _rel_l2(got, want))


@pytest.mark.parametrize("S", SPR_CASES)
def test_plain_backward_equals_autograd_f32(S):
    """In f32 K3's plain version is autograd through K2's: the weight grads,
    dx and dv (through sin/cos) of one cotangent."""
    net = NeRFMLP(CFG, seed=S, device="cpu")
    pts, vd, rng = _points(S, R, S)
    spr = S if S % 8 == 0 else 1
    x = torch.from_numpy(pts).reshape(-1, 3)
    v = torch.from_numpy(vd if spr > 1 else np.repeat(vd, S, 0))
    g = torch.from_numpy(rng.uniform(-1, 1, (R * S, 4)).astype(np.float32))
    with torch.no_grad():
        kp = fused_mlp.pack_params(net, PE_P, PE_V, torch.float32)
    grads, dx, dv = fused_mlp.fused_points_bwd(kp, x, v, g, spr, input_grads=True)
    leaves = {k: t.detach().clone().requires_grad_(True) for k, t in kp.items()}
    xa, va = x.clone().requires_grad_(True), v.clone().requires_grad_(True)
    (fused_mlp.fused_points_reference(leaves, xa, va, spr) * g).sum().backward()
    for name in fused_mlp.KP_NAMES:
        want = leaves[name].grad
        assert float((grads[name] - want).abs().max() / want.abs().max()) <= 1e-5, name
    for name, got, want in (("dx", dx, xa.grad), ("dv", dv, va.grad)):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5, name


@pytest.mark.parametrize("S", SPR_CASES)
def test_no_input_grads_keeps_weight_grads(S):
    """``input_grads=False`` leaves the weight grads as they are, bit for
    bit, and gives pts/viewdirs no grad (nerf_tpu: zeros,
    tests/test_fused_mlp.py:115-143)."""
    grads = {}
    for input_grads in (True, False):
        net = NeRFMLP(CFG, seed=7, device="cpu")
        pts, vd, rng = _points(7, R, S)
        p_t = torch.from_numpy(pts).requires_grad_(True)
        v_t = torch.from_numpy(vd).requires_grad_(True)
        out = _port_query(net, p_t, v_t, "bfloat16", input_grads=input_grads)
        (out * torch.from_numpy(rng.uniform(-1, 1, out.shape).astype(np.float32))).sum().backward()
        grads[input_grads] = [p.grad for p in net.parameters()]
        assert (p_t.grad is not None, v_t.grad is not None) == (input_grads, input_grads)
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


# (d) query_raw and whole train steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_raw_fused_matches_jax(dtype, monkeypatch):
    params = _jparams(3)
    net = _port_net(params)
    jmodel = JNeRFModel(JPE_P, JPE_V, JCFG, JCFG, dtype, fused=True)
    model = NeRFModel(PE_P, PE_V, CFG, CFG, dtype, fused=True)
    pts, vd, _ = _points(3, R, 21)
    ref = np.asarray(jnetwork.query_raw(params, JCFG, jmodel, jnp.asarray(pts), jnp.asarray(vd)))
    calls = []
    real = fused_mlp.fused_query
    monkeypatch.setattr(fused_mlp, "fused_query", lambda *a, **k: calls.append(k) or real(*a, **k))
    with torch.no_grad():
        out = tnetwork.query_raw(net, model, torch.from_numpy(pts), torch.from_numpy(vd)).numpy()
    assert len(calls) == 1 and calls[0]["input_grads"]  # the fused branch, nerf_tpu's default
    err = float(np.abs(out - ref).max())
    assert err <= (F32_TOL if dtype == "float32" else BF16_FWD_TOL), err


def test_train_steps_match_jax_points_in(monkeypatch):
    """Two train steps with coarse S = 13 and fine S = 21: both levels take
    the points-in path (nerf_tpu: K2/K3 with input_grads=False)."""
    n_samples, n_importance = 13, 8
    jmodel = JNeRFModel(JPE_P, JPE_V, JCFG, JCFG, "float32", fused=True)
    tmodel = NeRFModel(PE_P, PE_V, CFG, CFG, "float32", fused=True)
    kw = dict(n_samples=n_samples, n_importance=n_importance, white_bkgd=True)
    jrs, trs = jr.RenderSettings(**kw), tr.RenderSettings(**kw)
    params = {"coarse": _jparams(0), "fine": _jparams(1)}
    core = jax.jit(jstep.make_train_step_core(jmodel, jrs, LRATE, LRATE_DECAY))
    jstate = jstep.init_train_state(params, LRATE, LRATE_DECAY)
    state = tstep.init_train_state({k: _port_net(v) for k, v in params.items()}, LRATE)
    step = tstep.make_train_step(tmodel, trs, LRATE, LRATE_DECAY)
    k2, k3 = fused_mlp.fused_points.launches, fused_mlp.fused_points_bwd.launches
    queries = []
    real = fused_mlp.fused_points_bwd_reference
    monkeypatch.setattr(fused_mlp, "fused_points_bwd_reference",
                        lambda *a: queries.append(a[-1]) or real(*a))
    for i in range(2):
        rng = np.random.default_rng(10 + i)
        ro = (rng.standard_normal((R, 3)) * 0.3).astype(np.float32)
        rd = rng.standard_normal((R, 3)).astype(np.float32)
        target = rng.uniform(0, 1, (R, 3)).astype(np.float32)
        near, far = np.full(R, 2.0, np.float32), np.full(R, 6.0, np.float32)
        ov = {"t_rand": rng.uniform(size=(R, n_samples)).astype(np.float32),
              "u": rng.uniform(size=(R, n_importance)).astype(np.float32)}
        jstate, jaux = core(jstate, *(jnp.asarray(a) for a in (ro, rd, near, far, target)),
                            {k: jnp.asarray(v) for k, v in ov.items()})
        aux = step(state, *(torch.from_numpy(a) for a in (ro, rd, near, far, target)),
                   overrides={k: torch.from_numpy(v) for k, v in ov.items()})
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    # each step: one K3 plain call per level, without input grads
    assert queries == [False] * 4
    assert (fused_mlp.fused_points.launches, fused_mlp.fused_points_bwd.launches) == (k2, k3)
    got = {k: jax_params_from_state_dict(net.state_dict(), CFG) for k, net in state.nets.items()}
    # as tests/test_torch_port_train.py::test_train_steps_match_jax: Adam's
    # first updates are lr * sign(g), so small grad differences of the first
    # trunk layers move their updates most; a wrong update is off by order 1
    for (name, g, want), (_, p0, _) in zip(
        _leaf_pairs(got, jstate.params), _leaf_pairs(params, jstate.params)
    ):
        assert np.abs(g - want).max() <= 4 * LRATE, name
        err = _rel_l2(g - p0, want - p0)
        assert err <= UPDATE_TOL, (name, err)


# (e) the wrappers on the CPU


def test_points_wrappers_on_cpu():
    """On a CPU tensor K2's and K3's wrappers run their plain versions (the
    launch counters stay), check their inputs, and at S % 8 == 0 K2's plain
    version on o + d·z is K1's."""
    net = NeRFMLP(CFG, seed=4, device="cpu")
    kp = fused_mlp.pack_params(net, PE_P, PE_V, torch.bfloat16)
    rng = np.random.default_rng(4)
    ro, rd = (torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)) for _ in range(2))
    vd = rd / rd.norm(dim=-1, keepdim=True)
    z = torch.from_numpy(np.sort(rng.uniform(2, 6, (5, 16)).astype(np.float32), -1))
    x = fused_mlp._ray_points(ro, rd, z)
    counts = (fused_mlp.fused_points.launches, fused_mlp.fused_points_bwd.launches)
    with torch.no_grad():
        out = fused_mlp.fused_points(kp, x, vd, 16)
        planes = fused_mlp.fused_rays_planes(kp, ro, rd, vd, z)
        assert torch.equal(out, planes.reshape(4, -1).T)
        grads, dx, dv = fused_mlp.fused_points_bwd(kp, x, vd, torch.ones(80, 4), 16, False)
    assert dx is None and dv is None and set(grads) == set(fused_mlp.KP_NAMES)
    assert (fused_mlp.fused_points.launches, fused_mlp.fused_points_bwd.launches) == counts
    with pytest.raises(ValueError, match="spr"):
        fused_mlp.fused_points(kp, x, vd, 7)
    with pytest.raises(ValueError, match="v:"):
        fused_mlp.fused_points(kp, x, vd, 1)
    with pytest.raises(ValueError, match="x:"):
        fused_mlp.fused_points(kp, x.double(), vd, 16)
    with pytest.raises(ValueError, match="g:"):
        fused_mlp.fused_points_bwd(kp, x, vd, torch.ones(80, 3), 16)
    with pytest.raises(ValueError, match="device"):
        fused_mlp.fused_points(kp, x.to("meta"), vd.to("meta"), 16)
    assert fused_mlp.bwd_flops(CFG, PE_P, PE_V, 80, 1, input_grads=True) > fused_mlp.bwd_flops(
        CFG, PE_P, PE_V, 80, 1)
