"""The port's multi-scene training against nerf_tpu and against one scene
at a time, on the CPU.

nerf_tpu trains S scenes as one ``jax.vmap`` of its step
(nerf_tpu/parallel/multi_scene.py); the port stacks the S nets
(``StackedNeRFMLP``) and runs one step whose levels take the branch one
net would take, stacked: the stacked K1/K4, K2/K3 or K5/K6, each launched
once for every scene (on the CPU, their plain versions: the single-scene
kernels' scene by scene), or the stacked plain MLP. JAX's Pallas kernels
run in interpret mode, as tests/test_torch_port_train.py runs them. At the
smallest shapes that catch a wrong result: 8x128 nets, S = 2 or 3 scenes,
13 rays, 16 + 8 samples (both levels multiples of 8: the stacked K1/K4
branch), 15 + 8 (the points-in branch, K2/K3), 16 + 8 with fused_render
(K5/K6), 8 + 0 with fused_kernels off (the plain MLP).
"""

import contextlib
import dataclasses
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.experimental import fused_render as jfr
from nerf_tpu.geom.poses import pose_spherical as jpose_spherical
from nerf_tpu.models.embedding import PosEncConfig as JPosEnc
from nerf_tpu.models.nerf_mlp import MLPConfig as JMLPConfig
from nerf_tpu.models.nerf_mlp import init_params
from nerf_tpu.ops import fused_mlp as jfused
from nerf_tpu.parallel import multi_scene as jms
from nerf_tpu.render import renderer as jr
from nerf_tpu.render.network import NeRFModel as JNeRFModel
from nerf_tpu.train import step as jstep
from nerf_tpu_torch import config as tconfig
from nerf_tpu_torch.cli import train_multi
from nerf_tpu_torch.data import synth
from nerf_tpu_torch.data.rays_dataset import ImageRaySampler
from nerf_tpu_torch.experimental import fused_render as tfr
from nerf_tpu_torch.geom.rays import ndc_rays
from nerf_tpu_torch.models import factory as tfactory
from nerf_tpu_torch.models.convert import (
    jax_arrays_from_stacked_train_state, jax_params_from_state_dict,
    stacked_train_state_from_jax_arrays, state_dict_from_jax_params,
)
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import _build, fused_mlp, fused_mlp_wide
from nerf_tpu_torch.ops.sampling import stratified_z_vals
from nerf_tpu_torch.parallel import multi_scene as ms
from nerf_tpu_torch.render import renderer as tr
from nerf_tpu_torch.render.network import NeRFModel, StackedNeRFMLP, query_raw, query_raw_stacked
from nerf_tpu_torch.tools import make_multi_scenes
from nerf_tpu_torch.train import step as tstep
from nerf_tpu_torch.train.loop import load_scene, render_settings_from_config, train
from nerf_tpu_torch.utils import checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synthetic_scene import make_scene, write_blender_dataset  # noqa: E402
from test_torch_port_fused_mlp import WIDE_GRAD_TOL, _wide_nets, _wide_rays  # noqa: E402
from test_torch_port_train import (  # noqa: E402
    CFG, F32_PALLAS_GRAD_TOL, JCFG, JPE_P, JPE_V, LRATE, LRATE_DECAY, PE_P, PE_V, R,
    UPDATE_TOL, _conditioned_rays, _jparams, _min_preactivation, _port_net,
)

N_SAMPLES, N_IMPORTANCE = 16, 8
F32_FWD_TOL = 1e-5  # nerf_tpu's f32 forward bound (tests/test_fused_mlp.py:52-194)
# The stacked step against S one-scene steps on the same draws: the same
# ops on the same rays, but a reduction over a batch (the loss's mean, the
# render's sums over [S*R] rays, not [R]) may add in another order, which
# moves a grad in its last bits. Measured: the losses within 1.5e-7
# relative, so 1e-6. Adam moves a weight by about lr a step whatever the
# size of its grad, so such bits move a weight by up to a few lr: the
# weights are held to tests/test_torch_port_parallel.py's bounds for two
# runs whose sums run in other orders (4 lr, each leaf's update within
# UPDATE_TOL relative L2); measured up to 1e-4 (lr / 5) after 4 steps.
STEP_LOSS_RTOL = 1e-6


def _assert_trained_alike(got, want, start):
    """Weights by name trained from ``start`` in two runs whose sums run in
    other orders: each within 4 lr, each leaf's update within UPDATE_TOL."""
    for name, g in got.items():
        w, p0 = want[name].detach(), start[name].detach()
        assert float((g.detach() - w).abs().max()) <= 4 * LRATE, name
        moved = torch.linalg.norm(w - p0)
        if moved > 0:
            assert float(torch.linalg.norm(g.detach() - w) / moved) <= UPDATE_TOL, name


def _stacked(arrays):
    return [torch.stack([torch.as_tensor(a[s]) for a in arrays]) for s in range(len(arrays[0]))]


def _scene_rays(nets, S, n_samples=N_SAMPLES):
    """Per scene s: rays and depths whose relu inputs under nets[s] lie
    clear of zero (ROADMAP C.r3), as numpy."""
    return [_conditioned_rays(nets[s], n_samples)[:4] for s in range(S)]


def _assert_grads_match_jax(stacked, jgrads, S):
    """Each scene's grads of the stacked net within F32_PALLAS_GRAD_TOL of
    each leaf's largest entry of nerf_tpu's vmapped grads."""
    grads = {n: p.grad for n, p in stacked.named_parameters()}
    for s in range(S):
        got = jax_params_from_state_dict({n: g[s] for n, g in grads.items()}, CFG)
        want = jax.tree.map(lambda x: np.asarray(x)[s], jgrads)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= F32_PALLAS_GRAD_TOL, (s, jax.tree_util.keystr(path), err)


# (a) the stacked op: S single-scene calls, and jax.vmap of nerf_tpu's


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_op_is_single_scene_calls(dtype):
    """The stacked op's plain version (the CPU's) and its grads through the
    stacked net are the single-scene op's, scene by scene, bit for bit."""
    S = 3
    nets = [NeRFMLP(CFG, seed=20 + s, device="cpu") for s in range(S)]
    stacked = StackedNeRFMLP.from_nets(nets)
    rays = [_conditioned_rays(n, N_SAMPLES)[:4] for n in nets]
    ro, rd, vd, z = (torch.from_numpy(np.stack(a)) for a in zip(*rays))
    target = torch.rand(4, S, R, N_SAMPLES, generator=torch.Generator().manual_seed(0))
    before = fused_mlp.fused_rays_planes_stacked.launches, fused_mlp.fused_rays_planes_stacked_bwd.launches
    out = fused_mlp.fused_query_rays_planes_stacked(stacked, CFG, PE_P, PE_V, ro, rd, vd, z,
                                                    compute_dtype=dtype)
    assert out.shape == (4, S, R, N_SAMPLES)
    ((out - target) ** 2).mean((0, 2, 3)).sum().backward()
    assert (fused_mlp.fused_rays_planes_stacked.launches,
            fused_mlp.fused_rays_planes_stacked_bwd.launches) == before  # CPU: no launch
    grads = {n: p.grad for n, p in stacked.named_parameters()}
    for s, net in enumerate(nets):
        one = fused_mlp.fused_query_rays_planes(net, CFG, PE_P, PE_V, ro[s], rd[s], vd[s], z[s],
                                                compute_dtype=dtype)
        assert torch.equal(out[:, s], one), s
        ((one - target[:, s]) ** 2).mean().backward()
        for name, p in net.named_parameters():
            assert torch.equal(grads[name][s], p.grad), (s, name)


def test_stacked_op_matches_jax_vmap():
    """Against jax.vmap of nerf_tpu's fused_query_rays_planes over a scene
    axis (its Pallas K1/K4 in interpret mode), in f32: the forward within
    1e-5, each scene's grads within test_torch_port_train.py's
    F32_PALLAS_GRAD_TOL of each leaf's largest entry."""
    S = 2
    params = [_jparams(30 + s) for s in range(S)]
    nets = [_port_net(p) for p in params]
    rays = _scene_rays(nets, S)
    ro, rd, vd, z = (np.stack(a) for a in zip(*rays))
    target = np.random.default_rng(1).uniform(-1, 1, (S, 4, R, N_SAMPLES)).astype(np.float32)
    jparams = jax.tree.map(lambda *xs: np.stack(xs), *params)

    def jloss(p):
        out = jax.vmap(lambda p, *a: jfused.fused_query_rays_planes(
            p, JCFG, JPE_P, JPE_V, *a, compute_dtype=jnp.float32))(
            p, *(jnp.asarray(a) for a in (ro, rd, vd, z)))
        return jnp.sum(jnp.mean((out - target) ** 2, axis=(1, 2, 3))), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    stacked = StackedNeRFMLP.from_nets(nets)
    out = fused_mlp.fused_query_rays_planes_stacked(
        stacked, CFG, PE_P, PE_V, *(torch.from_numpy(a) for a in (ro, rd, vd, z)),
        compute_dtype=torch.float32)
    assert float((out.movedim(1, 0) - torch.from_numpy(np.asarray(jout))).abs().max()) <= F32_FWD_TOL
    ((out.movedim(1, 0) - torch.from_numpy(target)) ** 2).mean((1, 2, 3)).sum().backward()
    _assert_grads_match_jax(stacked, jgrads, S)


# The stacked K2/K3 and K5/K6 (and the stacked plain MLP): their plain
# versions (the CPU's) are the single-scene ops' scene by scene, and they
# hold to jax.vmap of nerf_tpu's fused_query and fused_render_level.
POINTS_SAMPLES = 15  # not a multiple of 8: a direction per point (spr = 1)


def _render_noise(S, n_samples=N_SAMPLES):
    rng = np.random.default_rng(7)
    return (rng.standard_normal((S, R, n_samples)) * 0.5).astype(np.float32)


def _map_loss(o, xp):
    """One-signed weights on every map of a stacked level's output (each
    [S, R, ...]); disp only where finite."""
    disp = xp.where(xp.isfinite(o.disp), o.disp, 0.0)
    return (((o.rgb - 0.5) ** 2).mean() + 0.3 * disp.mean() + 0.5 * o.acc.mean()
            + 0.7 * o.weights.mean()) * o.rgb.shape[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["points", "render", "plain"])
def test_stacked_points_render_plain_are_single_scene_calls(op, dtype):
    """The stacked K2/K3 (fused_query_stacked) and K5/K6
    (fused_render_level_stacked) through the stacked net, their plain
    versions on the CPU, are the single-scene ops (fused_query without input
    grads, fused_render_level) scene by scene, forward and grads bit for
    bit, with no launch counted. The stacked plain MLP (query_raw_stacked
    with fused_kernels off: StackedNeRFMLP.apply_mlp) against query_raw's
    NeRFMLP.apply_mlp scene by scene, with viewdirs and without (nets with
    an output_linear): its batched products sum in another order than one
    net's, so within 1e-6 (measured 1.5e-8); its calls are counted."""
    S = 2
    nets = [NeRFMLP(CFG, seed=60 + s, device="cpu") for s in range(S)]
    stacked = StackedNeRFMLP.from_nets(nets)
    n = POINTS_SAMPLES if op != "render" else N_SAMPLES
    ro, rd, vd, z = (torch.from_numpy(np.stack(a)) for a in zip(*_scene_rays(nets, S, n)))
    pts = ro[:, :, None] + rd[:, :, None] * z[..., None]
    noise = torch.from_numpy(_render_noise(S))
    counters = (fused_mlp.fused_points_stacked, fused_mlp.fused_points_stacked_bwd,
                tfr.fused_render_stacked_fwd, tfr.fused_render_stacked_bwd)
    before = [c.launches for c in counters], StackedNeRFMLP.plain_calls
    if op == "points":
        out = fused_mlp.fused_query_stacked(stacked, CFG, PE_P, PE_V, pts, vd, compute_dtype=dtype)
        out.square().mean((1, 2, 3)).sum().backward()
    elif op == "render":
        out = tfr.fused_render_level_stacked(stacked, CFG, PE_P, PE_V, ro, rd, vd, z, noise, True,
                                             compute_dtype=dtype)
        _map_loss(out, torch).backward()
    else:
        model = NeRFModel(PE_P, PE_V, CFG, CFG, "float32" if dtype == torch.float32 else "bfloat16")
        out = query_raw_stacked(stacked, model, pts, vd)
    assert [c.launches for c in counters] == before[0]  # CPU: no launch
    assert StackedNeRFMLP.plain_calls == before[1] + (op == "plain")
    grads = {n: p.grad for n, p in stacked.named_parameters()}
    for s, net in enumerate(nets):
        if op == "points":
            one = fused_mlp.fused_query(net, CFG, PE_P, PE_V, pts[s], vd[s], compute_dtype=dtype,
                                        input_grads=False)
            assert torch.equal(out[s], one), s
            one.square().mean().backward()
        elif op == "render":
            one = tfr.fused_render_level(net, CFG, PE_P, PE_V, ro[s], rd[s], vd[s], z[s],
                                         noise[s], True, compute_dtype=dtype)
            for name in ("rgb", "disp", "acc", "weights", "depth"):
                a, b = getattr(out, name)[s], getattr(one, name)
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (s, name)
            _map_loss(type(one)(*(t[None] for t in vars(one).values())), torch).backward()
        else:
            one = query_raw(net, model, pts[s], vd[s])
            assert float((out[s] - one).abs().max()) <= 1e-6, s
            continue
        for name, p in net.named_parameters():
            assert torch.equal(grads[name][s], p.grad), (s, name)
    if op == "plain":  # and without viewdirs: output_linear
        cfg_nv = dataclasses.replace(CFG, use_viewdirs=False)
        nets_nv = [NeRFMLP(cfg_nv, seed=64 + s, device="cpu") for s in range(S)]
        model_nv = NeRFModel(PE_P, None, cfg_nv, cfg_nv, model.compute_dtype)
        out = query_raw_stacked(StackedNeRFMLP.from_nets(nets_nv), model_nv, pts, None)
        for s, net in enumerate(nets_nv):
            one = query_raw(net, model_nv, pts[s], None)
            assert out[s].shape == one.shape and float((out[s] - one).abs().max()) <= 1e-6, s


def test_stacked_points_op_matches_jax_vmap():
    """The stacked K2/K3 (fused_query_stacked, no input grads) against
    jax.vmap of nerf_tpu's fused_query with input_grads=False over a scene
    axis (its Pallas K2/K3 in interpret mode), in f32 at 15 samples (a
    direction per point): the forward within 1e-5, each scene's grads within
    F32_PALLAS_GRAD_TOL of each leaf's largest entry."""
    S = 2
    params = [_jparams(70 + s) for s in range(S)]
    nets = [_port_net(p) for p in params]
    ro, rd, vd, z = (np.stack(a) for a in zip(*_scene_rays(nets, S, POINTS_SAMPLES)))
    pts = ro[:, :, None] + rd[:, :, None] * z[..., None]
    target = np.random.default_rng(2).uniform(-1, 1, (S, R, POINTS_SAMPLES, 4)).astype(np.float32)
    jparams = jax.tree.map(lambda *xs: np.stack(xs), *params)

    def jloss(p):
        out = jax.vmap(lambda p, x, v: jfused.fused_query(
            p, JCFG, JPE_P, JPE_V, x, v, compute_dtype=jnp.float32, input_grads=False))(
            p, jnp.asarray(pts), jnp.asarray(vd))
        return jnp.sum(jnp.mean((out - target) ** 2, axis=(1, 2, 3))), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    stacked = StackedNeRFMLP.from_nets(nets)
    out = fused_mlp.fused_query_stacked(stacked, CFG, PE_P, PE_V, torch.from_numpy(pts),
                                        torch.from_numpy(vd), compute_dtype=torch.float32)
    assert float((out - torch.from_numpy(np.asarray(jout))).abs().max()) <= F32_FWD_TOL
    ((out - torch.from_numpy(target)) ** 2).mean((1, 2, 3)).sum().backward()
    _assert_grads_match_jax(stacked, jgrads, S)


def test_stacked_render_op_matches_jax_vmap():
    """The stacked K5/K6 (fused_render_level_stacked) against jax.vmap of
    nerf_tpu's fused_render_level over a scene axis (its Pallas K5/K6 in
    interpret mode), in f32 with sigma noise and a white background: every
    map within 1e-5 (disp where finite), each scene's grads of a loss on
    every map within F32_PALLAS_GRAD_TOL of each leaf's largest entry."""
    S = 2
    params = [_jparams(80 + s) for s in range(S)]
    nets = [_port_net(p) for p in params]
    ro, rd, vd, z = (np.stack(a) for a in zip(*_scene_rays(nets, S)))
    noise = _render_noise(S)
    jparams = jax.tree.map(lambda *xs: np.stack(xs), *params)

    def jlevel(p):
        return jax.vmap(lambda p, *a: jfr.fused_render_level(
            p, JCFG, JPE_P, JPE_V, *a, True, compute_dtype=jnp.float32))(
            p, *(jnp.asarray(a) for a in (ro, rd, vd, z, noise)))

    jout = jax.jit(jlevel)(jparams)
    jgrads = jax.jit(jax.grad(lambda p: _map_loss(jlevel(p), jnp)))(jparams)
    stacked = StackedNeRFMLP.from_nets(nets)
    out = tfr.fused_render_level_stacked(stacked, CFG, PE_P, PE_V,
                                         *(torch.from_numpy(a) for a in (ro, rd, vd, z, noise)),
                                         True, compute_dtype=torch.float32)
    for name in ("rgb", "disp", "acc", "weights", "depth"):
        got, want = getattr(out, name).detach().numpy(), np.asarray(getattr(jout, name))
        assert got.shape == want.shape, name
        finite = np.isfinite(want)
        assert (np.isfinite(got) == finite).all(), name
        assert np.abs(got[finite] - want[finite]).max() <= F32_FWD_TOL, name
    _map_loss(out, torch).backward()
    _assert_grads_match_jax(stacked, jgrads, S)


# The stacked wide plans (ROADMAP C.3b): a stacked net at a configuration
# the W <= 256 tile is not built for runs ops/fused_mlp_wide.py's stacked
# plans (K1ws/K4ws, K2ws/K3ws, K5ws/K6ws). On the CPU they run on their
# primitives' plain versions (PlainOps), at W = 128 with mip-NeRF's 16 point
# and 6 view octaves (the cheapest wide configuration in interpret mode),
# S = 2 scenes whose points are not whole 256-point tiles.
WIDE_CFG = (128, 16, 6)


def _min_pre_kp(kp, x, v, spr):
    """The smallest |input| of any relu of the f32 forward of packed params
    at points x, a direction per spr points (ROADMAP C.r3)."""
    Fp, Fv = fused_mlp._num_freqs(kp)
    W_ = kp["W1"].shape[0]
    with torch.no_grad():
        z05 = fused_mlp._embed(x, Fp) @ kp["W05e"]
        pre = [z05[:, :W_] + kp["b0"]]
        for i in range(1, 8):
            zi = torch.relu(pre[-1]) @ kp[f"W{i}"] + kp[f"b{i}"]
            pre.append(zi + z05[:, W_:] if i == 5 else zi)
        feat = torch.relu(pre[-1]) @ kp["Wf"] + kp["bf"]
        ev = fused_mlp._embed(v, Fv) @ kp["Wve"]
        pre.append(feat @ kp["Wvf"] + ev.repeat_interleave(spr, 0) + kp["bv"])
    return min(float(t.abs().min()) for t in pre)


class _CountingOps(fused_mlp_wide.PlainOps):
    """PlainOps that records each primitive's calls and their scene counts."""

    def __init__(self):
        self.calls = []

    def gemm(self, *args, scenes=1, **kw):
        self.calls.append(("gemm", scenes))
        super().gemm(*args, scenes=scenes, **kw)

    def wgrad(self, *args):
        self.calls.append(("wgrad", args[-1] if len(args) > 8 else 1))
        super().wgrad(*args)


def _wide_stacked(S, seed, dtype=torch.float32):
    """S port nets of WIDE_CFG (random), stacked, and packed leaves of both."""
    W_, fp, fv = WIDE_CFG
    cfg = MLPConfig(width=W_, input_ch=3 + 6 * fp, input_ch_views=3 + 6 * fv)
    nets = [NeRFMLP(cfg, seed=seed + s, device="cpu") for s in range(S)]
    stacked = StackedNeRFMLP.from_nets(nets)
    with torch.no_grad():
        kp = fused_mlp.pack_params(stacked, PosEncConfig(fp), PosEncConfig(fv), dtype)
        one = [fused_mlp.pack_params(n, PosEncConfig(fp), PosEncConfig(fv), dtype) for n in nets]
    assert fused_mlp.is_wide(kp)
    return kp, one


def _same(a, b):
    """The same f32 bits (an empty ray's NaN disp equals itself)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_wide_plans_are_single_scene_plans(dtype):
    """Scene s of each stacked wide plan on PlainOps is the single-scene wide
    plan on scene s's net, bit for bit: K1ws/K4ws (13 rays of 16 samples),
    K2ws/K3ws (13 x 15 points, a direction a point, and 13 x 8, a direction
    a ray), K5ws/K6ws (13 rays of 16, noise, white background), each a
    launch a layer for every scene: the stacked plan makes as many GEMM and
    weight-grad calls as one scene's, each over both scenes. K6ws: its MLP
    half bit for bit on its compositing pass's cotangent, and that pass
    within f32 ulps of one scene's (the plain compositing backward's sums
    run in an order that depends on the number of rays; on the card the
    pass is a warp per ray, and tests/test_torch_port_kernels.py holds K6ws
    to single-scene launches bit for bit). (R N is a multiple of 16: the
    plain compositing's vectorised exp and log then see each value at the
    same place in both layouts.)"""
    S, R = 2, 13
    kp, one = _wide_stacked(S, 90, dtype)
    gen = torch.Generator().manual_seed(5)
    rnd = lambda *shape: torch.rand(*shape, generator=gen)  # noqa: E731
    ro, rd = rnd(S, R, 3) - 0.5, rnd(S, R, 3) - 0.5
    vd = rd / rd.norm(dim=-1, keepdim=True)
    z = torch.sort(2 + 4 * rnd(S, R, 16), -1).values
    g = (0.5 + rnd(4, S, R, 16)) * 1e-2
    with torch.no_grad():
        ops = _CountingOps()
        raw = fused_mlp_wide.rays_planes_stacked(ops, kp, ro, rd, vd, z)
        grads = fused_mlp_wide.rays_planes_stacked_bwd(ops, kp, ro, rd, vd, z, g)
        stacked_calls, ops.calls = ops.calls, []
        for s in range(S):
            assert _same(raw[:, s], fused_mlp_wide.rays_planes(ops, one[s], ro[s], rd[s], vd[s],
                                                               z[s])), s
            single = fused_mlp_wide.rays_planes_bwd(ops, one[s], ro[s], rd[s], vd[s], z[s],
                                                    g[:, s].contiguous())
            assert all(torch.equal(grads[k][s], t) for k, t in single.items()), s
            if s == 0:
                assert [c for c, _ in stacked_calls] == [c for c, _ in ops.calls]
                assert all(n == S for _, n in stacked_calls)
        for N, spr in ((15, 1), (8, 8)):
            x = (rnd(S, R * N, 3) - 0.5) * 4
            v = vd if spr > 1 else vd.repeat_interleave(N, 1)
            gp = (0.5 + rnd(S, R * N, 4)) * 1e-2
            out = fused_mlp_wide.points_raw_stacked(ops, kp, x, v, spr)
            gq = fused_mlp_wide.points_stacked_bwd(ops, kp, x, v, gp, spr)
            for s in range(S):
                assert _same(out[s], fused_mlp_wide.points_raw(ops, one[s], x[s], v[s], spr))
                single, _, _ = fused_mlp_wide.points_bwd(ops, one[s], x[s], v[s], gp[s], spr,
                                                         False)
                assert all(torch.equal(gq[k][s], t) for k, t in single.items()), (N, s)
        noise = rnd(S, R, 16) - 0.5
        maps = tfr.render_wide_stacked(ops, kp, ro, rd, vd, z, noise, True, keep_raw=True)
        cot = [(0.5 + rnd(*t.shape)) * 1e-3 for t in maps[:4]]
        g6 = tfr.render_wide_stacked_bwd(ops, kp, ro, rd, vd, z, noise, maps.raw, *cot, True)
        # K6ws's compositing pass over every scene's padded rays at once
        V = fused_mlp_wide.cols(R)
        pad = lambda t, dim=1: fused_mlp._padded((t,), V, dim)[0]  # noqa: E731
        g_all = ops.composite_bwd(
            pad(maps.raw, 2).flatten(1, 2), *(pad(t).flatten(0, 1) for t in (rd, z, noise, *cot)),
            True).view(4, S, V, 16)
        for s in range(S):
            raw1 = fused_mlp_wide.rays_planes(ops, one[s], ro[s], rd[s], vd[s], z[s])
            m1 = ops.composite(raw1, rd[s], z[s], noise[s], True)
            assert all(_same(a[s], b) for a, b in zip(maps[:4], m1[:4])), s
            gpl = ops.composite_bwd(raw1, rd[s], z[s], noise[s], *(c[s] for c in cot), True)
            # the plain compositing backward sums a ray's terms in an order
            # that depends on how many rays it takes: within f32 ulps
            assert float((g_all[:, s, :R] - gpl).abs().max()) <= 1e-6 * float(gpl.abs().max())
            single = fused_mlp_wide.rays_planes_bwd(ops, one[s], ro[s], rd[s], vd[s], z[s],
                                                    g_all[:, s, :R].contiguous())
            assert all(torch.equal(g6[k][s], t) for k, t in single.items()), s


class _Plan(torch.autograd.Function):
    """A stacked wide plan under autograd: ``fwd(kp)`` forward (a tensor or
    a tuple), ``bwd(kp, out, *cotangents)`` its grads of the packed leaves."""

    @staticmethod
    def forward(ctx, fwd, bwd, *leaves):
        ctx.kp, ctx.bwd = dict(zip(fused_mlp.KP_NAMES, leaves)), bwd
        with torch.no_grad():
            ctx.out = fwd(ctx.kp)
        return ctx.out

    @staticmethod
    def backward(ctx, *g):
        grads = ctx.bwd(ctx.kp, ctx.out, *(t.contiguous() for t in g))
        return (None, None) + tuple(grads[n] for n in fused_mlp.KP_NAMES)


def _jax_out_and_vjp(f, params, g):
    """(f(params), the vjp of f at params with cotangent g), one jit."""
    return jax.jit(lambda p: (f(p), jax.vjp(f, p)[1](jnp.asarray(g))[0]))(params)


@pytest.mark.parametrize("branch", ["rays", "points", "render"])
def test_stacked_wide_plans_match_jax_vmap(branch):
    """The stacked wide plans on PlainOps against jax.vmap of nerf_tpu's
    fused_query_rays_planes (K1ws/K4ws, 4 rays of 8), fused_query without
    input grads (K2ws/K3ws, 4 x 7 points, a direction a point) and
    fused_render_level (K5ws/K6ws, 4 rays of 8, noise, white background)
    over a scene axis (Pallas in interpret mode), f32, on inputs whose relu
    inputs lie clear of zero and whose points are exact
    (test_torch_port_fused_mlp.py's _wide_rays): the forward within 1e-5,
    each scene's grads within WIDE_GRAD_TOL (1e-5) of each leaf's largest
    entry."""
    S, R = 2, 4
    W_, fp, fv = WIDE_CFG
    made = [_wide_nets(W_, fp, fv, seed=95 + s) for s in range(S)]
    params, nets = [m[0] for m in made], [m[1] for m in made]
    (jcfg, jpp, jpv), (cfg, pe_p, pe_v) = made[0][2], made[0][3]
    N = 7 if branch == "points" else 8
    ro, rd, vd, z = (np.stack(a) for a in zip(*(_wide_rays(n, made[0][3], R, N) for n in nets)))
    jparams = jax.tree.map(lambda *xs: np.stack(xs), *params)
    stacked = StackedNeRFMLP.from_nets(nets)
    kp = fused_mlp.pack_params(stacked, pe_p, pe_v, torch.float32)
    leaves = [kp[n] for n in fused_mlp.KP_NAMES]
    ops = fused_mlp_wide.PlainOps()
    t = [torch.from_numpy(a) for a in (ro, rd, vd, z)]
    gen = np.random.default_rng(11)
    if branch == "rays":
        g = ((0.5 + gen.random((S, 4, R, N))) * 1e-2).astype(np.float32)

        def jf(p):
            return jax.vmap(lambda p, *a: jfused.fused_query_rays_planes(
                p, jcfg, jpp, jpv, *a, compute_dtype=jnp.float32))(
                p, *map(jnp.asarray, (ro, rd, vd, z)))

        ref, jg = _jax_out_and_vjp(jf, jparams, g)
        out = _Plan.apply(lambda k: fused_mlp_wide.rays_planes_stacked(ops, k, *t),
                          lambda k, o, gg: fused_mlp_wide.rays_planes_stacked_bwd(ops, k, *t, gg),
                          *leaves).movedim(1, 0)
        out.backward(torch.from_numpy(g))
    elif branch == "points":
        pts = (ro[:, :, None] + rd[:, :, None] * z[..., None]).astype(np.float32)
        g = ((0.5 + gen.random((S, R, N, 4))) * 1e-2).astype(np.float32)

        def jf(p):
            return jax.vmap(lambda p, x, v: jfused.fused_query(
                p, jcfg, jpp, jpv, x, v, compute_dtype=jnp.float32, input_grads=False))(
                p, jnp.asarray(pts), jnp.asarray(vd))

        ref, jg = _jax_out_and_vjp(jf, jparams, g)
        x = torch.from_numpy(pts).reshape(S, R * N, 3)
        v = t[2].repeat_interleave(N, 1)
        out = _Plan.apply(lambda k: fused_mlp_wide.points_raw_stacked(ops, k, x, v, 1),
                          lambda k, o, gg: fused_mlp_wide.points_stacked_bwd(ops, k, x, v, gg, 1),
                          *leaves).reshape(S, R, N, 4)
        out.backward(torch.from_numpy(g))
    else:
        noise = (gen.standard_normal((S, R, N)) * 0.5).astype(np.float32)

        def jlevel(p):
            return jax.vmap(lambda p, *a: jfr.fused_render_level(
                p, jcfg, jpp, jpv, *a, True, compute_dtype=jnp.float32))(
                p, *map(jnp.asarray, (ro, rd, vd, z, noise)))

        jout, jg = jax.jit(lambda p: (jlevel(p), jax.grad(lambda q: _map_loss(jlevel(q), jnp))(p)))(
            jparams)
        nz = torch.from_numpy(noise)
        maps = _Plan.apply(
            lambda k: tuple(tfr.render_wide_stacked(ops, k, *t, nz, True, keep_raw=True)),
            lambda k, o, *c: tfr.render_wide_stacked_bwd(ops, k, *t, nz, o[4], *c[:4], True),
            *leaves)
        o = tfr.Maps(*maps)
        for got, want in zip(o[:4], (jout.rgb, jout.disp, jout.acc, jout.weights)):
            got, want = got.detach().numpy(), np.asarray(want)
            finite = np.isfinite(want)
            assert got.shape == want.shape and (np.isfinite(got) == finite).all()
            assert np.abs(got[finite] - want[finite]).max() <= F32_FWD_TOL
        _map_loss(type("L", (), dict(rgb=o.rgb, disp=o.disp, acc=o.acc, weights=o.w)), torch
                  ).backward()
        ref = None
    if ref is not None:
        assert float((out.detach() - torch.from_numpy(np.asarray(ref))).abs().max()) <= F32_FWD_TOL
    grads = {n: p.grad for n, p in stacked.named_parameters()}
    for s in range(S):
        got = jax_params_from_state_dict({n: gr[s] for n, gr in grads.items()}, cfg)
        want = jax.tree.map(lambda a: np.asarray(a)[s], jg)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
            err = float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())
            assert err <= WIDE_GRAD_TOL, (branch, s, jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("failure", ["build", "error_code"])
def test_stacked_wide_cuda_path_failure_raises_without_fallback(failure, monkeypatch):
    """At a wide configuration a build that fails or a launch that returns
    an error raises from the stacked wrappers' wide plans (K1ws, K4ws,
    K2ws, K3ws, K5ws, K6ws); none falls back to a plain version, and no
    counter moves."""
    S, R, N = 2, 3, 8
    kp, _ = _wide_stacked(S, 96, torch.bfloat16)
    gen = torch.Generator().manual_seed(6)
    ro, rd = torch.rand(S, R, 3, generator=gen), torch.rand(S, R, 3, generator=gen) + 0.1
    vd = rd / rd.norm(dim=-1, keepdim=True)
    z = torch.sort(2 + 4 * torch.rand(S, R, N, generator=gen), -1).values
    x, g = torch.rand(S, R * N, 3, generator=gen), torch.ones(S, R * N, 4)
    cot = (torch.ones(S, R, 3), torch.ones(S, R), torch.ones(S, R), torch.ones(S, R, N))
    raw = torch.zeros(4, S, R, N)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    # the CPU tensors take the CUDA path: the stacked wrappers' wide branch

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    for mod, name in ((fused_mlp, "fused_rays_planes_stacked_reference"),
                      (fused_mlp, "fused_rays_planes_stacked_bwd_reference"),
                      (fused_mlp, "fused_points_stacked_reference"),
                      (fused_mlp, "fused_points_stacked_bwd_reference"),
                      (tfr, "fused_render_stacked_reference"),
                      (tfr, "fused_render_stacked_bwd_reference"),
                      (tfr, "composite_maps_reference"), (tfr, "composite_bwd_reference")):
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
    counters = (fused_mlp_wide.fused_rays_planes_wide_stacked,
                fused_mlp_wide.fused_rays_planes_wide_stacked_bwd,
                fused_mlp_wide.fused_points_wide_stacked,
                fused_mlp_wide.fused_points_wide_stacked_bwd,
                tfr.fused_render_wide_stacked_fwd, tfr.fused_render_wide_stacked_bwd)
    counts = [c.launches for c in counters]
    calls = (lambda: fused_mlp_wide.fused_rays_planes_wide_stacked(kp, ro, rd, vd, z),
             lambda: fused_mlp_wide.fused_rays_planes_wide_stacked_bwd(kp, ro, rd, vd, z, raw),
             lambda: fused_mlp_wide.fused_points_wide_stacked(kp, x, vd, N),
             lambda: fused_mlp_wide.fused_points_wide_stacked_bwd(kp, x, vd, g, N),
             lambda: tfr.fused_render_wide_stacked_fwd(kp, ro, rd, vd, z, None, True, None,
                                                       False),
             lambda: tfr.fused_render_wide_stacked_bwd(kp, ro, rd, vd, z, None, raw, *cot, True))
    for call in calls:
        with pytest.raises(RuntimeError, match=match):
            call()
    assert [c.launches for c in counters] == counts


# (b) whole stacked steps: nerf_tpu's make_multi_scene_step, S one-scene steps


def _ff_batch(s, n=R):
    """Forward-facing rays (z towards -1: NDC divides by d_z), nerf_tpu's
    tests/test_multi_scene.py's."""
    rng = np.random.default_rng(s)
    ro = rng.standard_normal((n, 3)).astype(np.float32) * 0.05
    rd = rng.standard_normal((n, 3)).astype(np.float32) * 0.2
    rd[:, 2] = -1.0 - np.abs(rd[:, 2])
    tgt = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return ro, rd, np.zeros(n, np.float32), np.ones(n, np.float32), tgt


def _batch(s, n=R):
    rng = np.random.default_rng(s)
    ro = (rng.standard_normal((n, 3)) * 0.3).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    return (ro, rd, np.full(n, 2.0, np.float32), np.full(n, 6.0, np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _conditioned_step(net, make_batch, seed, hwf=None, margin=2e-6, n_samples=N_SAMPLES,
                      n_importance=N_IMPORTANCE, min_pre=_min_preactivation, t_grid=None):
    """A batch (make_batch(seed + k)) and its jitter t_rand and importance u
    whose coarse relu inputs under ``net`` all lie further than ``margin``
    from zero (ROADMAP C.r3; test_torch_port_train.py's _conditioned_rays for
    a whole step: the coarse depths are the jittered ones, the marching rays
    NDC's with ``hwf``). Where one lies closer, the two packages' f32
    forwards can put it on opposite sides and Adam turns that into an
    update off by order 1 of the cancelling early trunk grads: on the
    single-scene step too (one such batch put a leaf's update 0.108 off)."""
    for k in range(100):
        batch = make_batch(seed + k)
        rng = np.random.default_rng(seed + k)
        ov = {"t_rand": rng.uniform(size=(R, n_samples)).astype(np.float32)}
        if t_grid:  # jitter on a grid: exact depths (_grid_batch)
            ov["t_rand"] = (np.round(ov["t_rand"] * t_grid) / t_grid).astype(np.float32)
        if n_importance:
            ov["u"] = rng.uniform(size=(R, n_importance)).astype(np.float32)
        ro, rd, near, far = (torch.from_numpy(a) for a in batch[:4])
        vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        if hwf is not None:
            ro, rd = ndc_rays(*hwf, 1.0, ro, rd)
        z = stratified_z_vals(near, far, n_samples, perturb=True,
                              t_rand=torch.from_numpy(ov["t_rand"]))
        if min_pre(net, *(t.numpy() for t in (ro, rd, vd, z))) > margin:
            return batch, ov
    raise AssertionError("no well-conditioned batch in 100 seeds")


# (ndc, n_samples, n_importance, fused, fused_render, steps) of each branch
# of the stacked step: the raygen K1/K4 (blender and NDC), the points-in
# K2/K3 (15 + 8), the fused render K5/K6 (16 + 8), the plain MLP
# (fused_kernels off at 8 + 0, nerf_tpu's own multi-scene CLI test config,
# tests/test_multi_scene.py::test_train_multi_cli_on_mesh), and the
# points-in pair at WIDE_CFG (17 + 0: the stacked wide plans' guard,
# K2ws/K3ws on the card; no fine level, whose importance samples at 16
# octaves are ill-conditioned, ROADMAP C.r2). The branches added to the
# raygen pair take one step: the second step's Adam carry is the raygen
# pair's.
# At 16 octaves a point's top phase x 2^15 turns by 8e-3 rad for one ulp of
# x, so the wide path's points are exact in both packages: 17 samples
# (linspace steps of 1/16), jitter on a 1/256 grid and rays on grids
# (_grid_batch), so that z and x = o + d z need no rounding whether or not a
# multiply and add contract into an FMA (as _wide_rays does for one level).
STEP_PATHS = {"blender": (False, N_SAMPLES, N_IMPORTANCE, True, False, 2),
              "ndc": (True, N_SAMPLES, N_IMPORTANCE, True, False, 2),
              "points": (False, POINTS_SAMPLES, N_IMPORTANCE, True, False, 1),
              "fused_render": (False, N_SAMPLES, N_IMPORTANCE, True, True, 1),
              "plain": (False, 8, 0, False, False, 1),
              "wide": (False, 17, 0, True, False, 1)}
STEP_CONFIGS = {"wide": WIDE_CFG}  # (width, point and view octaves); else 128, 10, 4


def _grid_batch(s, n=R):
    """_batch's rays on grids: origins of 2^-8, directions of 2^-4."""
    ro, rd, near, far, tgt = _batch(s, n)
    rd = np.round(rd * 16) / 16
    rd[np.abs(rd).sum(-1) == 0] = 0.5
    return (np.round(ro * 256) / 256).astype(np.float32), rd.astype(np.float32), near, far, tgt


def _step_nets(path):
    """(JAX and port MLP and posenc configs, nerf_tpu's params of a seed as
    a port net, nerf_tpu's params of a seed, the min relu input of a net's
    coarse level) at the path's configuration."""
    W_, fp, fv = STEP_CONFIGS.get(path, (128, 10, 4))
    jcfg = JMLPConfig(width=W_, input_ch=3 + 6 * fp, input_ch_views=3 + 6 * fv)
    cfg = MLPConfig(width=W_, input_ch=3 + 6 * fp, input_ch_views=3 + 6 * fv)
    pe_p, pe_v = PosEncConfig(fp), PosEncConfig(fv)

    def jparams(seed):
        return jax.tree.map(np.asarray, init_params(jax.random.key(seed), jcfg))

    def port_net(params):
        net = NeRFMLP(cfg, device="cpu")
        net.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
        return net

    def min_pre(net, ro, rd, vd, z):
        kp = fused_mlp.pack_params(net, pe_p, pe_v, torch.float32)
        x = fused_mlp._ray_points(*(torch.from_numpy(a) for a in (ro, rd, z)))
        return _min_pre_kp(kp, x, torch.from_numpy(vd), z.shape[1])

    return (jcfg, JPosEnc(fp), JPosEnc(fv)), (cfg, pe_p, pe_v), jparams, port_net, min_pre


@pytest.mark.parametrize("path", list(STEP_PATHS))
def test_multi_scene_steps_match_jax(path):
    """Steps of make_multi_scene_step against jax.vmap of nerf_tpu's
    make_train_step_core over the scene axis (what its
    make_multi_scene_step vmaps) on the same stacked draws, on every branch
    of the step (STEP_PATHS, the points-in pair also at WIDE_CFG), and with NDC two scenes of different (H, W,
    focal), each an operand per scene (its hwf_operand): each scene's loss
    within rtol 1e-5, its weights within test_train_steps_match_jax's bounds
    (4 lr, each leaf's update within UPDATE_TOL relative L2), on batches
    whose coarse relu inputs lie clear of zero (_conditioned_step)."""
    S = 2
    ndc, n_samples, n_importance, fused, fused_render, n_steps = STEP_PATHS[path]
    (jcfg, jpp, jpv), (cfg, pe_p, pe_v), jparams, port_net, min_pre = _step_nets(path)
    kw = dict(n_samples=n_samples, n_importance=n_importance, ndc=ndc, white_bkgd=not ndc)
    jrs, trs = jr.RenderSettings(**kw), tr.RenderSettings(**kw)
    fine_j, fine_t = (jcfg, cfg) if n_importance else (None, None)
    jmodel = JNeRFModel(jpp, jpv, jcfg, fine_j, "float32", fused=fused,
                        fused_render=fused_render)
    tmodel = NeRFModel(pe_p, pe_v, cfg, fine_t, "float32", fused=fused, fused_render=fused_render)
    params = [{"coarse": jparams(40 + 2 * s), "fine": jparams(41 + 2 * s)} for s in range(S)]
    if not n_importance:
        params = [{"coarse": p["coarse"]} for p in params]
    jstate = jms.stack_states([jstep.init_train_state(p, LRATE, LRATE_DECAY) for p in params])
    state = ms.stack_states([tstep.init_train_state({k: port_net(v) for k, v in p.items()}, LRATE)
                             for p in params])
    core = jstep.make_train_step_core(jmodel, jrs, LRATE, LRATE_DECAY, hwf_operand=ndc)
    mstep = jax.jit(jax.vmap(core))
    step = ms.make_multi_scene_step(tmodel, trs, LRATE, LRATE_DECAY, S)
    hwfs = [(40, 50, 35.0), (24, 30, 20.0)]
    extra = (jnp.asarray(hwfs, jnp.float32),) if ndc else ()
    plain_calls = StackedNeRFMLP.plain_calls
    for i in range(n_steps):
        wide = path in STEP_CONFIGS
        steps = [_conditioned_step(state.nets["coarse"].net(s),
                                   _ff_batch if ndc else _grid_batch if wide else _batch,
                                   1000 * i + 100 * s, hwfs[s] if ndc else None,
                                   n_samples=n_samples, n_importance=n_importance,
                                   min_pre=min_pre, t_grid=256 if wide else None)
                 for s in range(S)]
        arrays = _stacked([b for b, _ in steps])
        ov = {k: np.stack([o[k] for _, o in steps]) for k in steps[0][1]}
        jstate, jaux = mstep(jstate, *(jnp.asarray(a.numpy()) for a in arrays),
                             {k: jnp.asarray(v) for k, v in ov.items()}, *extra)
        aux = step(state, *arrays, overrides={k: torch.from_numpy(v) for k, v in ov.items()},
                   hwf=torch.tensor(hwfs) if ndc else None)
        assert aux["loss"].shape == (S,)
        np.testing.assert_allclose(aux["loss"].numpy(), np.asarray(jaux["loss"]), rtol=1e-5)
    # the stacked plain MLP runs only where no kernel applies (at WIDE_CFG
    # too: the stacked wide plans' guard is nerf_tpu's)
    assert fused_mlp.supports_stacked(cfg, pe_p, pe_v)
    assert StackedNeRFMLP.plain_calls - plain_calls == (0 if fused else n_steps)
    got = jax_arrays_from_stacked_train_state(state, tmodel)["params"]
    start = jax.tree.map(lambda *xs: np.stack(xs), *params)
    for (path, g), want, p0 in zip(jax.tree_util.tree_leaves_with_path(got),
                                   jax.tree.leaves(jstate.params), jax.tree.leaves(start)):
        want = np.asarray(want)
        assert np.abs(g - want).max() <= 4 * LRATE, jax.tree_util.keystr(path)
        for s in range(S):
            err = np.linalg.norm(g[s] - want[s]) / np.linalg.norm(want[s] - p0[s])
            assert err <= UPDATE_TOL, (s, jax.tree_util.keystr(path), err)


def test_stacked_step_equals_one_scene_steps():
    """The stacked step equals S one-scene steps (make_train_step) on the
    same rays and draws, scene by scene: the losses within STEP_LOSS_RTOL,
    the weights trained alike (_assert_trained_alike), aux one value a
    scene."""
    S = 3
    model = NeRFModel(PE_P, PE_V, CFG, CFG, "float32", fused=True)
    rs = tr.RenderSettings(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, white_bkgd=True)
    seeds = [ms.scene_seed(0, k) for k in range(S)]
    state = ms.init_multi_scene_state(model, seeds, LRATE, "cpu")
    step = ms.make_multi_scene_step(model, rs, LRATE, LRATE_DECAY, S)
    singles = [tstep.init_train_state(tfactory.init_nets(model, s, "cpu"), LRATE) for s in seeds]
    one = tstep.make_train_step(model, rs, LRATE, LRATE_DECAY)
    for i in range(2):
        batches = [_batch(100 + 10 * i + s) for s in range(S)]
        gens = [torch.Generator().manual_seed(s + 2) for s in seeds]
        draws = [tstep.draw_overrides(torch.Generator().manual_seed(s + 2), R, rs) for s in seeds]
        aux = step(state, *_stacked(batches), generators=gens)
        assert set(aux) == {"loss", "psnr", "img_loss", "img_loss0", "psnr0"}
        assert all(v.shape == (S,) for v in aux.values())
        for k, st in enumerate(singles):
            a = one(st, *(torch.from_numpy(x) for x in batches[k]), overrides=draws[k])
            for key in aux:
                np.testing.assert_allclose(float(aux[key][k]), float(a[key]), rtol=STEP_LOSS_RTOL)
    for k, st in enumerate(singles):
        for level, net in st.nets.items():
            start = dict(tfactory.init_nets(model, seeds[k], "cpu")[level].named_parameters())
            _assert_trained_alike(state.nets[level].scene_state_dict(k),
                                  dict(net.named_parameters()), start)


def test_one_adam_is_s_adams():
    """One Adam over the stacked leaves is S Adams with the shared step
    count and schedule (Adam is elementwise), bit for bit; the stacked
    state's moments unstack to theirs."""
    S = 3
    model = NeRFModel(PE_P, PE_V, CFG, None, "float32", fused=True)
    seeds = [ms.scene_seed(7, k) for k in range(S)]
    state = ms.init_multi_scene_state(model, seeds, LRATE, "cpu")
    singles = [tstep.init_train_state(tfactory.init_nets(model, s, "cpu"), LRATE) for s in seeds]
    lr = tstep.lr_schedule(LRATE, LRATE_DECAY)
    gen = torch.Generator().manual_seed(3)
    for t in range(3):
        for name, p in state.nets["coarse"].named_parameters():
            p.grad = torch.randn(p.shape, generator=gen)
            for k, st in enumerate(singles):
                dict(st.nets["coarse"].named_parameters())[name].grad = p.grad[k].clone()
        for st in [state] + singles:
            for group in st.optimizer.param_groups:
                group["lr"] = lr(t)
            st.optimizer.step()
    for k, (got, st) in enumerate(zip(ms.unstack_states(state, S), singles)):
        want = dict(st.nets["coarse"].named_parameters())
        for name, p in got.nets["coarse"].named_parameters():
            assert torch.equal(p, want[name]), (k, name)
            for m in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(got.optimizer.state[p][m], st.optimizer.state[want[name]][m])


def test_stacked_state_carries_over_from_jax():
    """A stacked nerf_tpu state (params, Adam moments, count, step) into the
    port's stacked state and back, unchanged."""
    S = 2
    model = NeRFModel(PE_P, PE_V, CFG, CFG, "float32", fused=True)
    rng = np.random.default_rng(4)
    params = [{"coarse": _jparams(50 + 2 * s), "fine": _jparams(51 + 2 * s)} for s in range(S)]
    stack = jax.tree.map(lambda *xs: np.stack(xs), *params)
    arrays = {"params": stack, "mu": jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), stack),
              "nu": jax.tree.map(lambda x: rng.uniform(size=x.shape).astype(np.float32), stack),
              "count": 3, "step": 3}
    state = stacked_train_state_from_jax_arrays(arrays, model, LRATE, "cpu")
    assert state.step == 3 and state.nets["fine"].n_scenes == S
    back = jax_arrays_from_stacked_train_state(state, model)
    assert back["count"] == back["step"] == 3
    for key in ("params", "mu", "nu"):
        for a, b in zip(jax.tree.leaves(arrays[key]), jax.tree.leaves(back[key])):
            np.testing.assert_array_equal(a, b)
    sd = state_dict_from_jax_params(params[1]["fine"], CFG)
    for name, p in state.nets["fine"].named_parameters():
        assert torch.equal(p[1], sd[name]), name


# (c) the stacked sampler


def test_stacked_sampler_equals_image_samplers():
    """One sampling pass for S scenes draws what S ImageRaySamplers with the
    same generators draw, bit for bit, across the precrop boundary (step 3)."""
    scenes = [make_scene(n_train=3, n_test=1, H=16, W=16, seed=s) for s in (0, 1, 2)]
    gens = lambda: [torch.Generator().manual_seed(10 + k) for k in range(3)]  # noqa: E731
    solo = [ImageRaySampler(s, 24, g, precrop_iters=3, precrop_frac=0.5, device="cpu")
            for s, g in zip(scenes, gens())]
    stacked = ms.StackedImageSampler(scenes, 24, gens(), precrop_iters=3, precrop_frac=0.5,
                                     device="cpu")
    for step in range(1, 6):
        batch = stacked.next_batch(step)
        assert all(t.shape == (3, 24, 3) for t in batch)
        for k, smp in enumerate(solo):
            for got, want in zip(batch, smp.next_batch(step)):
                assert torch.equal(got[k], want), (step, k)


def test_stacked_sampler_raises_on_scenes_of_other_shapes():
    a = make_scene(n_train=3, n_test=1, H=16, W=16)
    gens = [torch.Generator(), torch.Generator()]
    with pytest.raises(ValueError, match="homogeneous"):
        ms.StackedImageSampler([a, make_scene(n_train=3, n_test=1, H=12, W=16)], 8, gens,
                               device="cpu")
    with pytest.raises(ValueError, match="homogeneous"):
        ms.StackedImageSampler([a, make_scene(n_train=2, n_test=1, H=16, W=16)], 8, gens,
                               device="cpu")


# (d) the CLI and the scene writer


def _configs(tmp_path, n=2, **over):
    paths = []
    for s in range(n):
        d = write_blender_dataset(str(tmp_path / f"data{s}"), n_train=3, n_val=1, n_test=1,
                                  H=16, W=16)
        flags = {"expname": f"ms{s}", "basedir": f"{tmp_path}/logs", "datadir": d,
                 "dataset_type": "blender", "no_batching": True, "use_viewdirs": True,
                 "white_bkgd": True, "N_rand": 32, "N_samples": 8, "N_importance": 8,
                 "netwidth": 128, "netwidth_fine": 128, "half_res": False, "testskip": 1,
                 "compute_dtype": "float32", "precrop_iters": 2, **over}
        cfg = tmp_path / f"scene{s}.txt"
        cfg.write_text("".join(f"{k} = {v}\n" for k, v in flags.items()))
        paths.append(str(cfg))
    return paths


def test_train_multi_trains_each_scene_as_cli_train(tmp_path, capsys):
    """train_multi.main on two 16x16 scenes on the CPU: the [TRAIN-MULTI]
    lines, a .tar a scene at i_weights that loads into the one-scene model,
    and each scene trained as train() trains it alone with the scene's seed
    (scene_seed): the loss within STEP_LOSS_RTOL, the weights trained
    alike."""
    paths = _configs(tmp_path)
    common = ["--n_iters", "4", "--i_print", "2", "--i_weights", "4", "--data_axis", "1"]
    result = train_multi.main(["--configs", *paths, *common], device="cpu")
    out = capsys.readouterr().out
    assert out.count("[TRAIN-MULTI] Iter") == 2 and "ms1: loss" in out
    assert [h[0] for h in result.history] == [2, 4] and result.scenes == [0, 1]
    cfgs = train_multi.load_configs(["--configs", *paths, *common])
    model = tfactory.make_model(cfgs[0])
    for k, cfg in enumerate(cfgs):
        tar = tmp_path / "logs" / f"ms{k}" / "000004.tar"
        loaded = checkpoint.load_checkpoint(str(tar), model, cfg.lrate, "cpu")
        alone = train(tconfig.NeRFConfig(**{**cfg.__dict__, "seed": ms.scene_seed(0, k),
                                            "expname": f"alone{k}", "i_weights": 0}),
                      device="cpu")
        np.testing.assert_allclose(alone.history[-1][1], result.history[-1][1][k],
                                   rtol=STEP_LOSS_RTOL)
        start = tfactory.init_nets(model, ms.scene_seed(0, k), "cpu")
        for level, net in loaded.nets.items():
            mine = result.state.nets[level].scene_state_dict(k)
            for name, p in net.named_parameters():
                assert torch.equal(p, mine[name]), (k, name)
            _assert_trained_alike(mine, dict(alone.state.nets[level].named_parameters()),
                                  dict(start[level].named_parameters()))


def test_train_multi_refuses_what_one_step_cannot_take(tmp_path):
    """Configs that disagree on a shared field, or none, exit; every branch
    one scene trains on trains stacked: 7 + 8 samples (the stacked K2/K3),
    --fused_render (K5/K6) and fused_kernels off (the stacked plain MLP,
    whose calls are counted there only) each train a step of both scenes
    on the CPU, the loss finite."""
    paths = _configs(tmp_path)
    other = _configs(tmp_path / "b", n=1, N_rand=16)[0]
    with pytest.raises(SystemExit, match="N_rand"):
        train_multi.main(["--configs", paths[0], other, "--n_iters", "1"], device="cpu")
    with pytest.raises(SystemExit, match="--configs"):
        train_multi.main(["--n_iters", "1"], device="cpu")
    for flag, plain in ((["--N_samples", "7"], False), (["--fused_render"], False),
                        (["--fused_kernels", "False"], True)):
        before = StackedNeRFMLP.plain_calls
        result = train_multi.main(["--configs", *paths, "--n_iters", "1", "--i_print", "1",
                                   "--i_weights", "0", "--data_axis", "1", *flag], device="cpu")
        ((_, losses, _),) = result.history
        assert losses.shape == (2,) and np.isfinite(losses).all(), flag
        assert StackedNeRFMLP.plain_calls - before == (2 if plain else 0), flag


def test_multi_scene_writer_reads_back(tmp_path):
    """tools/make_multi_scenes.py's scenes: scene k's poses are nerf_tpu's
    tool's (default_rng(1000 + k), radius 4), and a view loads through the
    blender loader as the port's render_gt_image of field 200 + k, truncated
    to 8 bits."""
    counts = {"train": 2, "val": 1, "test": 1}
    written = make_multi_scenes.write_scenes(str(tmp_path), 2, counts, res=8, device="cpu")
    focal = 0.5 * 8 / np.tan(0.5 * make_multi_scenes.CAMERA_ANGLE_X)
    for k, poses in enumerate(written):
        rng = np.random.default_rng(1000 + k)
        for split, n in counts.items():
            for i in range(n):
                theta, phi = rng.uniform(-180.0, 180.0), rng.uniform(-80.0, -10.0)
                np.testing.assert_array_equal(poses[split][i],
                                              np.asarray(jpose_spherical(theta, phi, 4.0)))
        scene = load_scene(tconfig.NeRFConfig(datadir=str(tmp_path / f"multi_{k}"),
                                              dataset_type="blender", white_bkgd=True, testskip=1))
        img = synth.render_gt_image(synth.make_field(seed=200 + k), 8, 8, focal,
                                    poses["test"][0], device="cpu")
        want = (np.clip(img, 0, 1) * 255).astype(np.uint8) / 255.0
        np.testing.assert_array_equal(scene.images[3], want.astype(np.float32))


# (e) the sweep's fused chunk (tools/multiscene_sweep.py): k stacked steps
# with their StackedImageSampler draws as one ChunkRunner chunk, eager on
# the CPU (the CUDA graph's plain version)

CHUNK_K, CHUNK_RAYS = 3, 32


def _chunk_cfg(dtype="float32", **over):
    """configs/multi's recipe at the file's shapes: 8x128 nets, 16 + 8
    samples (the stacked K1/K4 branch), CHUNK_RAYS rays a scene."""
    return tconfig.NeRFConfig(**{
        "dataset_type": "blender", "no_batching": True, "use_viewdirs": True, "white_bkgd": True,
        "N_rand": CHUNK_RAYS, "N_samples": N_SAMPLES, "N_importance": N_IMPORTANCE,
        "netwidth": 128, "netwidth_fine": 128, "lrate": LRATE, "lrate_decay": LRATE_DECAY,
        "compute_dtype": dtype, **over})


def _chunk_pack(cfg, scene_ids, k=CHUNK_K):
    """The sweep's Pack of the scenes ``scene_ids`` (16x16, 3 train views),
    scene k seeded scene_seed(0, k)."""
    from nerf_tpu_torch.tools import multiscene_sweep

    scenes = [make_scene(n_train=3, n_test=1, H=16, W=16, seed=s) for s in scene_ids]
    schedule = tstep.lr_schedule(cfg.lrate, cfg.lrate_decay)
    table = torch.tensor([schedule(t) for t in range(4 * k)], dtype=torch.float32)
    seeds = [ms.scene_seed(0, s) for s in scene_ids]
    return multiscene_sweep.Pack(cfg, scenes, seeds, k, table, torch.device("cpu")), scenes, seeds


def _pack_leaves(pack):
    """Every parameter and Adam entry of a pack's stacked state, by name."""
    out = {}
    for level, net in pack.state.nets.items():
        for name, p in net.named_parameters():
            out[f"{level}.{name}"] = p.detach()
            for key, v in pack.state.optimizer.state.get(p, {}).items():
                out[f"{level}.{name}.{key}"] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_chunk_equals_stacked_steps(dtype):
    """Two chunks of CHUNK_K steps of the sweep's runner (ChunkRunner's
    eager path over make_stacked_train_step, the learning rate a float32
    tensor from the table) against the same stacked steps one by one on
    the same generators (lr from the schedule): losses, weights, Adam's
    moments and counts, and every generator's state torch.equal."""
    cfg = _chunk_cfg(dtype)
    fused, _, _ = _chunk_pack(cfg, [0, 1])
    eager, _, _ = _chunk_pack(cfg, [0, 1])
    step = ms.make_multi_scene_step(eager.model, render_settings_from_config(cfg), cfg.lrate,
                                    cfg.lrate_decay, 2)
    got, want = [], []
    for _ in range(2):
        aux = fused.chunk()
        assert aux["loss"].shape == (CHUNK_K, 2)
        got.append(aux["loss"])
        for _ in range(CHUNK_K):
            ro, rd, tgt = eager.sampler.next_batch(eager.state.step + 1)
            a = step(eager.state, ro, rd, eager.runner.near, eager.runner.far, tgt,
                     generators=eager.step_gens)
            want.append(a["loss"])
    assert fused.state.step == eager.state.step == 2 * CHUNK_K
    assert torch.equal(torch.cat(got), torch.stack(want))
    a, b = _pack_leaves(fused), _pack_leaves(eager)
    assert a.keys() == b.keys() and len(a) > 0
    for name in a:
        assert torch.equal(a[name], b[name]), name
    for g, h in zip(fused.runner.generators, eager.runner.generators):
        assert torch.equal(g.get_state(), h.get_state())


def test_scene_in_a_pack_trains_as_alone():
    """Scene k in a pack of 3 trains as scene k alone (S = 1) over two
    chunks: the same draws (its own generators), so each step's loss within
    STEP_LOSS_RTOL and its weights trained alike (_assert_trained_alike);
    the alone runs go through one S = 1 pack, each scene ``load``-ed into
    its buffers (the sweep's sequential runs), and scene 2 loaded after the
    others trains bit for bit as in a pack made for it."""
    cfg = _chunk_cfg()
    pack, scenes, seeds = _chunk_pack(cfg, [0, 1, 2])
    packed = torch.cat([pack.chunk()["loss"] for _ in range(2)])
    mine = [ms.unstack_states(pack.state, 3)[k] for k in range(3)]
    alone, _, _ = _chunk_pack(cfg, [0])
    for k in range(3):
        if k:
            alone.load([scenes[k]], [seeds[k]])
        losses = torch.cat([alone.chunk()["loss"] for _ in range(2)])
        np.testing.assert_allclose(packed[:, k].numpy(), losses[:, 0].numpy(),
                                   rtol=STEP_LOSS_RTOL)
        start = tfactory.init_nets(alone.model, seeds[k], "cpu")
        for level, net in mine[k].nets.items():
            _assert_trained_alike(dict(net.named_parameters()),
                                  alone.state.nets[level].scene_state_dict(0),
                                  dict(start[level].named_parameters()))
    fresh, _, _ = _chunk_pack(cfg, [2])
    fresh_losses = torch.cat([fresh.chunk()["loss"] for _ in range(2)])
    assert torch.equal(fresh_losses, losses)
    a, b = _pack_leaves(alone), _pack_leaves(fresh)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_stacked_chunks_match_jax_sweep_body():
    """Two chunks of the port's runner (S = 2, CHUNK_K steps each, f32)
    against nerf_tpu's sweep body on the same batches and draws: jax.lax.scan
    over CHUNK_K steps of jax.vmap(make_train_step_core), as
    tools/multiscene_sweep.py:112-126 runs it (there with keys; here the
    batches the port's sampler drew and the streams its step generators
    drew, replayed from their states before each chunk), JAX's kernels in
    interpret mode: each step's losses within rtol 1e-5 and the weights
    within test_multi_scene_steps_match_jax's bounds (4 lr, each scene's
    leaf's update within UPDATE_TOL relative L2)."""
    cfg = _chunk_cfg()
    pack, scenes, seeds = _chunk_pack(cfg, [0, 1])
    rs = render_settings_from_config(cfg)
    jmodel = JNeRFModel(JPE_P, JPE_V, JCFG, JCFG, "float32", fused=True)
    jrs = jr.RenderSettings(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, white_bkgd=True)
    start = [{lvl: jax_params_from_state_dict(net.state_dict(), CFG)
              for lvl, net in tfactory.init_nets(pack.model, s, "cpu").items()} for s in seeds]
    jstate = jms.stack_states([jstep.init_train_state(p, LRATE, LRATE_DECAY) for p in start])
    core = jstep.make_train_step_core(jmodel, jrs, LRATE, LRATE_DECAY)
    near = jnp.full((2, CHUNK_RAYS), 2.0, jnp.float32)
    far = jnp.full((2, CHUNK_RAYS), 6.0, jnp.float32)

    @jax.jit
    def run(st, xs):
        def body(st, x):
            ro, rd, tgt, ov = x
            st, aux = jax.vmap(core)(st, ro, rd, near, far, tgt, ov)
            return st, aux["loss"]

        return jax.lax.scan(body, st, xs)

    def copies(gens):
        out = []
        for g in gens:
            c = torch.Generator()
            c.set_state(g.get_state())
            out.append(c)
        return out

    for _ in range(2):
        first = pack.state.step + 1
        sampler = ms.StackedImageSampler(scenes, CHUNK_RAYS, copies(pack.sample_gens),
                                         device="cpu")
        step_gens = copies(pack.step_gens)
        batches, draws = [], []
        for j in range(CHUNK_K):
            batches.append([t.numpy() for t in sampler.next_batch(first + j)])
            per = [tstep.draw_overrides(g, CHUNK_RAYS, rs) for g in step_gens]
            draws.append({k: np.stack([d[k].numpy() for d in per]) for k in per[0]})
        losses = pack.chunk()["loss"].numpy()
        xs = (*(jnp.asarray(np.stack([b[i] for b in batches])) for i in range(3)),
              {k: jnp.asarray(np.stack([d[k] for d in draws])) for k in draws[0]})
        jstate, jlosses = run(jstate, xs)
        np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-5)
    got = jax_arrays_from_stacked_train_state(pack.state, pack.model)["params"]
    p0 = jax.tree.map(lambda *xs: np.stack(xs), *start)
    for (path, g), want, s0 in zip(jax.tree_util.tree_leaves_with_path(got),
                                   jax.tree.leaves(jstate.params), jax.tree.leaves(p0)):
        want = np.asarray(want)
        assert np.abs(g - want).max() <= 4 * LRATE, jax.tree_util.keystr(path)
        for s in range(2):
            err = np.linalg.norm(g[s] - want[s]) / np.linalg.norm(want[s] - s0[s])
            assert err <= UPDATE_TOL, (s, jax.tree_util.keystr(path), err)


def _dict_keys(tree):
    """The string keys of every dict literal in a parsed module."""
    import ast

    return [{k.value for k in node.keys if isinstance(k, ast.Constant)}
            for node in ast.walk(tree) if isinstance(node, ast.Dict)]


def test_multiscene_sweep_tool_end_to_end(tmp_path, monkeypatch, capsys):
    """nerf_tpu_torch.tools.multiscene_sweep.main on the CPU, from a
    directory holding configs/multi/scene_{0,1}.txt and their relative
    datadirs (16x16 scenes), with a net shrunk by config overrides: the
    concurrent runs S = 1, 2 and the sequential x2, nerf_tpu's JSON record
    (its keys, read from tools/multiscene_sweep.py's source, never imported)
    with the device and no card, finite holdout PSNRs, and each run's
    per-step losses [n_iters, S] and weights; with no device it raises
    where there is no card."""
    import ast

    from nerf_tpu_torch.tools import multiscene_sweep

    monkeypatch.chdir(tmp_path)
    (tmp_path / "configs" / "multi").mkdir(parents=True)
    for k in range(2):
        write_blender_dataset(str(tmp_path / "data" / f"multi_{k}"), n_train=3, n_val=1,
                              n_test=1, H=16, W=16)
        flags = {"expname": f"multi_{k}", "datadir": f"./data/multi_{k}",
                 "dataset_type": "blender", "no_batching": True, "use_viewdirs": True,
                 "white_bkgd": True, "N_rand": 16, "N_samples": 4, "N_importance": 4,
                 "half_res": False, "testskip": 1, "precrop_iters": 500}
        (tmp_path / "configs" / "multi" / f"scene_{k}.txt").write_text(
            "".join(f"{a} = {b}\n" for a, b in flags.items()))
    shrink = ["--netdepth", "2", "--netdepth_fine", "2", "--netwidth", "32",
              "--netwidth_fine", "32", "--multires", "2", "--multires_views", "1",
              "--fused_kernels", "False", "--compute_dtype", "float32"]
    if not torch.cuda.is_available():  # no device given: the card, or an error
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multiscene_sweep.main(["--scenes", "2", *shrink])
    result = multiscene_sweep.main(["--n_iters", "120", "--scenes", "2", "--out",
                                    "out/sweep.json", *shrink], device="cpu")
    out = capsys.readouterr().out
    assert out.count("[SWEEP]") == 3
    record = json.loads((tmp_path / "out" / "sweep.json").read_text())
    assert record == result.record
    source = ast.parse((Path(__file__).resolve().parents[1] / "tools"
                        / "multiscene_sweep.py").read_text())
    keys = _dict_keys(source)
    top = next(k for k in keys if "runs" in k)
    concurrent = next(k for k in keys if "per_scene_rays_per_sec" in k)
    sequential = next(k for k in keys if "total_wall_s" in k)
    assert set(record) == top | {"device", "card"}
    assert record["device"] == "cpu" and record["card"] is None
    assert record["n_iters"] == 100 and record["fuse"] == multiscene_sweep.FUSE == 50
    assert [r["label"] for r in record["runs"]] == ["concurrent_S1", "concurrent_S2",
                                                    "sequential_2x"]
    assert set(record["runs"][0]) == set(record["runs"][1]) == concurrent
    assert set(record["runs"][2]) == sequential
    assert all(np.isfinite(p) for r in record["runs"] for p in r["holdout_psnr"])
    assert [len(r["holdout_psnr"]) for r in record["runs"]] == [1, 2, 2]
    assert [(r.label, r.losses.shape, r.steps) for r in result.runs] == [
        ("concurrent_S1", (100, 1), 50), ("concurrent_S2", (100, 2), 50),
        ("sequential_0", (100, 1), 50), ("sequential_1", (100, 1), 50)]
    assert all(np.isfinite(r.losses).all() for r in result.runs)
