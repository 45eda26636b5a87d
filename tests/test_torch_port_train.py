"""The port's training slice against nerf_tpu, on the CPU.

The same numpy inputs go through both packages: the fused op's backward
(K4's plain version against jax.grad through nerf_tpu's Pallas kernels, run
in interpret mode), the loss and its grads, Adam with the decay schedule,
whole train steps, the ray samplers, the config and model factory, the
train-state carry-over, and ``train()`` itself. The CUDA kernel is checked
on the card by tests/test_torch_port_kernels.py and chip_smoke.py.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu import config as jconfig
from nerf_tpu.data import rays_dataset as jdata
from nerf_tpu.models import factory as jfactory
from nerf_tpu.models.embedding import PosEncConfig as JPosEnc
from nerf_tpu.models.embedding import posenc
from nerf_tpu.models.nerf_mlp import MLPConfig as JMLPConfig
from nerf_tpu.models.nerf_mlp import apply_mlp, init_params
from nerf_tpu.ops import fused_mlp as jfused
from nerf_tpu.render import renderer as jr
from nerf_tpu.render.network import NeRFModel as JNeRFModel
from nerf_tpu.train import step as jstep
from nerf_tpu_torch import config as tconfig
from nerf_tpu_torch.data import rays_dataset as tdata
from nerf_tpu_torch.data.scene import Scene
from nerf_tpu_torch.geom.rays import get_rays
from nerf_tpu_torch.models import factory as tfactory
from nerf_tpu_torch.models.convert import (
    jax_arrays_from_train_state,
    jax_params_from_state_dict,
    state_dict_from_jax_params,
    train_state_from_jax_arrays,
)
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import fused_mlp
from nerf_tpu_torch.render import renderer as tr
from nerf_tpu_torch.render.network import NeRFModel
from nerf_tpu_torch.train import step as tstep
from nerf_tpu_torch.train.loop import train

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synthetic_scene import make_scene  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
W = 128  # the fused kernels need a multiple of 128
R = 13  # a ragged ray count
N_SAMPLES, N_IMPORTANCE = 16, 8  # coarse S=16, fine S=24: both take the fused branch
CFG, JCFG = MLPConfig(width=W), JMLPConfig(width=W)
PE_P, PE_V = PosEncConfig(10), PosEncConfig(4)
JPE_P, JPE_V = JPosEnc(10), JPosEnc(4)
# f32 grads, relative to each leaf's largest entry. Against jax.grad through
# nerf_tpu's plain MLP (apply_mlp): 1e-5 (measured 4e-7). Against jax.grad
# through its Pallas kernels: nerf_tpu's raygen backward itself lies up to
# 1.7e-5 from that same plain autodiff on these inputs (its sin/cos and
# sums differ), so 5e-5.
F32_GRAD_TOL = 1e-5
F32_PALLAS_GRAD_TOL = 5e-5
# bf16 grads, per-leaf relative L2: both sides round at the same points,
# but nerf_tpu's bf16 posenc is a polynomial (max error 1.8e-5) where the
# port takes sin/cos, and the sums run in another order, so some embedding
# entries and activations round to the other bf16 neighbour and the trunk's
# small, cancelling grads move most. Measured here: up to 2.4e-2 (trunk 0).
# nerf_tpu holds its own bf16 grads to 0.05 (tests/test_fused_mlp.py:175-183).
BF16_GRAD_TOL = 0.05
LOSS_GRAD_TOL = 1e-2  # per-leaf relative L2 through the whole render (see its test)
UPDATE_TOL = 5e-2  # per-leaf relative L2 of two Adam steps' update (see its test)
LRATE, LRATE_DECAY = 5e-4, 500


def _jparams(seed):
    return jax.tree.map(np.asarray, init_params(jax.random.key(seed), JCFG))


def _port_net(params):
    net = NeRFMLP(CFG, device="cpu")
    net.load_state_dict(state_dict_from_jax_params(params, CFG), strict=True)
    return net


def _grads_as_jax(net):
    return jax_params_from_state_dict({n: p.grad for n, p in net.named_parameters()}, CFG)


def _leaf_pairs(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree.leaves(b)
    assert len(la) == len(lb)
    return [(jax.tree_util.keystr(p), np.asarray(x), np.asarray(y)) for (p, x), y in zip(la, lb)]


def _min_preactivation(net, ro, rd, vd, z):
    """Smallest |input| of any relu of the fused MLP's trunk and view layer."""
    with torch.no_grad():
        kp = fused_mlp.pack_params(net, PE_P, PE_V, torch.float32)
        n, S = z.shape
        x = torch.from_numpy(ro)[:, None] + torch.from_numpy(rd)[:, None] * torch.from_numpy(z)[..., None]
        e = fused_mlp._embed(x.reshape(-1, 3), PE_P.num_freqs)
        z05 = e @ kp["W05e"]
        pre = [z05[:, :W] + kp["b0"]]
        for i in range(1, 8):
            zi = torch.relu(pre[-1]) @ kp[f"W{i}"] + kp[f"b{i}"]
            pre.append(zi + z05[:, W:] if i == 5 else zi)
        feat = torch.relu(pre[-1]) @ kp["Wf"] + kp["bf"]
        ev = fused_mlp._embed(torch.from_numpy(vd), PE_V.num_freqs) @ kp["Wve"]
        pre.append(feat @ kp["Wvf"] + ev.repeat_interleave(S, 0) + kp["bv"])
        return min(float(t.abs().min()) for t in pre)


def _conditioned_rays(net, S, margin=2e-6):
    """Rays and depths whose relu inputs all lie further than ``margin``
    from zero. The two packages' f32 forwards differ by ~1e-6 (sin/cos and
    summation order), so a relu input closer to zero than that can switch
    its mask in one package only; at init the first trunk layers' grads are
    small sums that nearly cancel, and one such switch moves a leaf by up to
    ~7% of its largest entry, a difference of inputs and not of the backward."""
    for seed in range(100):
        ro, rd, vd, z, rng = _rays(1000 * S + seed, R, S)
        if _min_preactivation(net, ro, rd, vd, z) > margin:
            return ro, rd, vd, z, rng
    raise AssertionError("no well-conditioned inputs in 100 seeds")


def _rays(seed, n, S=None):
    rng = np.random.default_rng(seed)
    ro = (rng.standard_normal((n, 3)) * 0.3).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = None if S is None else np.sort(rng.uniform(2, 6, (n, S)).astype(np.float32), -1)
    return ro, rd, vd, z, rng


# (a) the differentiable fused op: K4's plain version against jax.grad


@pytest.mark.parametrize("S", [16, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_op_grads_match_jax(S, dtype):
    params = _jparams(S)
    net = _port_net(params)
    ro, rd, vd, z, rng = _conditioned_rays(net, S)
    target = rng.uniform(-1, 1, (4, R, S)).astype(np.float32)

    def jloss(p):
        out = jfused.fused_query_rays_planes(
            p, JCFG, JPE_P, JPE_V, *(jnp.asarray(a) for a in (ro, rd, vd, z)),
            compute_dtype=getattr(jnp, dtype),
        )
        return jnp.mean((out - target) ** 2)

    def jplain(p):
        pts = jnp.asarray(ro)[:, None] + jnp.asarray(rd)[:, None] * jnp.asarray(z)[..., None]
        v = jnp.broadcast_to(jnp.asarray(vd)[:, None], (R, S, 3))
        raw = apply_mlp(p, JCFG, posenc(pts.reshape(-1, 3), JPE_P), posenc(v.reshape(-1, 3), JPE_V))
        return jnp.mean((raw.T.reshape(4, R, S) - target) ** 2)

    ref = jax.jit(jax.grad(jloss))(params)
    before = fused_mlp.fused_rays_planes_bwd.launches
    out = fused_mlp.fused_query_rays_planes(
        net, CFG, PE_P, PE_V, *(torch.from_numpy(a) for a in (ro, rd, vd, z)),
        compute_dtype=getattr(torch, dtype),
    )
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    assert fused_mlp.fused_rays_planes_bwd.launches == before  # CPU: the plain version
    grads = _grads_as_jax(net)
    for name, got, want in _leaf_pairs(grads, ref):
        assert got.shape == want.shape, name
        if dtype == "float32":
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= F32_PALLAS_GRAD_TOL, (name, err)
        else:
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= BF16_GRAD_TOL, (name, err)
    if dtype == "float32" and S == 24:  # once: eager JAX autodiff is slow
        with jax.default_matmul_precision("highest"):
            plain = jax.grad(jplain)(params)  # eager: jit fuses the f32 math differently
        for name, got, want in _leaf_pairs(grads, plain):
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= F32_GRAD_TOL, (name, err)


def test_fused_op_grad_dtypes_and_no_input_grads():
    """Weight grads come back in each packed leaf's dtype; rays, viewdirs
    and depths get none (nerf_tpu/ops/fused_mlp.py:899-908)."""
    net = NeRFMLP(CFG, seed=2, device="cpu")
    with torch.no_grad():
        kp = fused_mlp.pack_params(net, PE_P, PE_V, torch.bfloat16)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in kp.items()}
    ro, rd, vd, z, _ = _rays(0, R, 16)
    rays = [torch.from_numpy(a).requires_grad_(True) for a in (ro, rd, vd, z)]
    out = fused_mlp.fused_rays_planes_autograd(leaves, *rays)
    out.sum().backward()
    for k, v in leaves.items():
        assert v.grad is not None and v.grad.dtype == kp[k].dtype, k
    assert all(t.grad is None for t in rays)


# (b) loss_fn and its grads


def _models(compute_dtype="float32"):
    return (
        JNeRFModel(JPE_P, JPE_V, JCFG, JCFG, compute_dtype, fused=True),
        NeRFModel(PE_P, PE_V, CFG, CFG, compute_dtype, fused=True),
    )


def _settings(**kw):
    kw = dict(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, white_bkgd=True) | kw
    return jr.RenderSettings(**kw), tr.RenderSettings(**kw)


def _batch(seed):
    ro, rd, vd, _, rng = _rays(seed, R)
    target = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    ov = {
        "t_rand": rng.uniform(size=(R, N_SAMPLES)).astype(np.float32),
        "u": rng.uniform(size=(R, N_IMPORTANCE)).astype(np.float32),
    }
    near, far = np.full(R, 2.0, np.float32), np.full(R, 6.0, np.float32)
    return (ro, rd, vd, near, far, target), ov


def test_loss_fn_value_and_grads_match_jax():
    jmodel, tmodel = _models()
    jrs, trs = _settings()
    params = {"coarse": _jparams(0), "fine": _jparams(1)}
    nets = {k: _port_net(v) for k, v in params.items()}
    arrays, ov = _batch(3)
    def jloss(p, arrays, ov):
        return jstep.loss_fn(p, jmodel, jrs, *arrays, None, ov)

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, tuple(jnp.asarray(a) for a in arrays), {k: jnp.asarray(v) for k, v in ov.items()}
    )
    loss, aux = tstep.loss_fn(
        nets, tmodel, trs, *(torch.from_numpy(a) for a in arrays),
        overrides={k: torch.from_numpy(v) for k, v in ov.items()},
    )
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    # Through the whole render the grads move for reasons outside the op:
    # the fine depths come from the coarse weights' CDF, whose sums round
    # differently, so a fine depth may move by an ulp and raw by ~1e-4
    # (ROADMAP C), and the first trunk layers' grads are small, cancelling
    # sums. Measured: heads and late trunk layers within 2e-4, the first
    # trunk layers up to 4.6e-3 relative L2.
    got = {k: _grads_as_jax(net) for k, net in nets.items()}
    for name, g, want in _leaf_pairs(got, jgrads):
        err = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert err <= LOSS_GRAD_TOL, (name, err)


# (c) Adam and the schedule


def test_adam_and_lr_schedule_match_optax():
    sched = jstep.lr_schedule(LRATE, LRATE_DECAY)
    ours = tstep.lr_schedule(LRATE, LRATE_DECAY)
    for t in (0, 1, 500_000):
        np.testing.assert_allclose(ours(t), float(sched(t)), rtol=1e-6)
    assert ours(0) == LRATE
    params = {"coarse": _jparams(0)}
    nets = {"coarse": _port_net(params["coarse"])}
    tx = jstep.make_optimizer(LRATE, LRATE_DECAY)
    update = jax.jit(tx.update)
    jstate = tstep.init_train_state(nets, LRATE)
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    for t in range(3):  # optax counts 0, 1, 2
        grads = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params
        )
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        sd = state_dict_from_jax_params(grads["coarse"], CFG)
        for n, p in nets["coarse"].named_parameters():
            p.grad = sd[n].clone()
        tstep.set_lr(jstate.optimizer, ours(t))  # the tensor the train step sets
        jstate.optimizer.step()
    got = {"coarse": jax_params_from_state_dict(nets["coarse"].state_dict(), CFG)}
    for name, g, want in _leaf_pairs(got, params):
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-7, err_msg=name)


# (d) whole train steps


def test_train_steps_match_jax():
    jmodel, tmodel = _models()
    jrs, trs = _settings()
    params = {"coarse": _jparams(0), "fine": _jparams(1)}
    core = jax.jit(jstep.make_train_step_core(jmodel, jrs, LRATE, LRATE_DECAY))
    jstate = jstep.init_train_state(params, LRATE, LRATE_DECAY)
    state = tstep.init_train_state({k: _port_net(v) for k, v in params.items()}, LRATE)
    step = tstep.make_train_step(tmodel, trs, LRATE, LRATE_DECAY)
    for i in range(2):
        (ro, rd, _, near, far, target), ov = _batch(10 + i)
        jstate, jaux = core(jstate, *(jnp.asarray(a) for a in (ro, rd, near, far, target)),
                            {k: jnp.asarray(v) for k, v in ov.items()})
        aux = step(state, *(torch.from_numpy(a) for a in (ro, rd, near, far, target)),
                   overrides={k: torch.from_numpy(v) for k, v in ov.items()})
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 2
    got = {k: jax_params_from_state_dict(net.state_dict(), CFG) for k, net in state.nets.items()}
    # Adam moves a weight by about lr per step whatever the size of its grad
    # (its first update is lr * sign(g)), so the small grad differences of
    # the loss_fn test move the updates of the first trunk layers most:
    # measured up to 1.6e-2 relative L2 of a leaf's two-step update, the
    # others near 1e-5. A wrong update would be off by order 1.
    for (name, g, want), (_, p0, _) in zip(
        _leaf_pairs(got, jstate.params), _leaf_pairs(params, jstate.params)
    ):
        assert np.abs(g - want).max() <= 4 * LRATE, name
        err = np.linalg.norm((g - p0) - (want - p0)) / np.linalg.norm(want - p0)
        assert err <= UPDATE_TOL, (name, err)


def test_draw_overrides_shapes():
    rs = tr.RenderSettings(n_samples=8, n_importance=4, perturb=True, raw_noise_std=1.0)
    ov = tstep.draw_overrides(torch.Generator().manual_seed(0), 5, rs)
    jov = jstep.draw_overrides(jax.random.key(0), 5, jr.RenderSettings(**dataclasses.asdict(rs)))
    assert list(ov) == list(jov)
    for k in ov:
        assert tuple(ov[k].shape) == jov[k].shape and ov[k].dtype == torch.float32, k


# (e) ray buffer and samplers


@pytest.fixture(scope="module")
def scene():
    return make_scene(n_train=3, n_test=1, H=16, W=20)


def test_ray_buffer_bit_equal(scene):
    np.testing.assert_array_equal(tdata.build_ray_buffer(scene), jdata.build_ray_buffer(scene))


def test_batched_sampler_covers_every_ray_once(scene):
    n_total = 3 * 16 * 20
    sampler = tdata.BatchedRaySampler(scene, 64, torch.Generator().manual_seed(0), device="cpu")
    buf = torch.from_numpy(tdata.build_ray_buffer(scene))
    seen = []
    for _ in range(n_total // 64):
        ro, rd, rgb = sampler.next_batch()
        assert ro.shape == rd.shape == rgb.shape == (64, 3)
        seen.append(torch.cat([ro, rd, rgb], -1))
    seen = torch.cat(seen)
    # the first n_total // 64 windows of one epoch: no ray twice
    assert torch.unique(seen, dim=0).shape[0] == seen.shape[0]
    # across the epoch boundary the window wraps: tail of the old + head of the new
    rest = sampler.perm.shape[0] - sampler.i_batch
    sampler.next_batch()
    assert sampler.perm.shape[0] == n_total + rest and sampler.i_batch == 64
    assert torch.equal(torch.sort(sampler.perm[rest:]).values, torch.arange(n_total))
    # and together the windows of an epoch are the whole buffer
    epoch = buf[sampler.perm[rest:]].reshape(n_total, 9)
    assert torch.equal(torch.unique(epoch, dim=0), torch.unique(buf.reshape(n_total, 9), dim=0))


@pytest.mark.parametrize("step", [1, 10])
def test_image_sampler_batches(scene, step):
    n_rand = 40
    sampler = tdata.ImageRaySampler(scene, n_rand, torch.Generator().manual_seed(1),
                                    precrop_iters=5, precrop_frac=0.5, device="cpu")
    ro, rd, rgb = sampler.next_batch(step)
    assert ro.shape == rd.shape == rgb.shape == (n_rand, 3)
    row0, col0, rows, cols = sampler.crop if step < 5 else sampler.full
    assert sampler.crop == jdata.ImageRaySampler(
        scene, n_rand, jax.random.key(0), precrop_iters=5, precrop_frac=0.5)._crop
    # find the image and pixels each ray came from
    hits = []
    for i in scene.i_train:
        fo, fd = get_rays(scene.H, scene.W, scene.K, torch.from_numpy(scene.poses[i]))
        match = (fd[:, :, None, :] == rd[None, None]).all(-1)  # [H, W, n_rand]
        if bool(match.any(0).any(0).all()) and bool((fo[0, 0] == ro).all()):
            hits.append((i, match))
    assert len(hits) == 1
    i, match = hits[0]
    r, c, k = torch.nonzero(match, as_tuple=True)
    order = torch.argsort(k)
    r, c = r[order], c[order]
    assert torch.equal(k[order], torch.arange(n_rand))  # one pixel per ray
    assert len({(int(a), int(b)) for a, b in zip(r, c)}) == n_rand  # no pixel twice
    assert bool(((r >= row0) & (r < row0 + rows) & (c >= col0) & (c < col0 + cols)).all())
    torch.testing.assert_close(rgb, torch.from_numpy(scene.images[i])[r, c], rtol=0, atol=0)


# (f) config and model factory


def test_lego_config_and_model_match_jax():
    path = str(REPO / "configs" / "lego.txt")
    assert tconfig.parse_config_file(path) == jconfig.parse_config_file(path)
    for argv in ([f"--config={path}"], [f"--config={path}", "--N_rand=4096", "--no_batching=False"]):
        ours, ref = tconfig.load_config(argv), jconfig.load_config(argv)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert tconfig.dump_config(ours) == jconfig.dump_config(ref)
    cfg = tconfig.load_config([f"--config={path}"])
    ours, ref = tfactory.make_model(cfg), jfactory.make_model(cfg)
    for field in ("coarse", "fine"):
        assert dataclasses.asdict(getattr(ours, field)) == dataclasses.asdict(getattr(ref, field))
    assert (ours.pe_pts.num_freqs, ours.pe_views.num_freqs) == (10, 4)
    assert (ours.compute_dtype, ours.fused) == (ref.compute_dtype, ref.fused)
    nets = tfactory.init_nets(ours, seed=0, device="cpu")
    assert set(nets) == {"coarse", "fine"} and nets["fine"].cfg == ours.fine


# (g) train-state carry-over


def test_train_state_round_trip():
    jmodel, tmodel = _models()
    params = {"coarse": _jparams(0), "fine": _jparams(1)}
    tx = jstep.make_optimizer(LRATE, LRATE_DECAY)
    jstate = jstep.init_train_state(params, LRATE, LRATE_DECAY, start_step=7)
    rng = np.random.default_rng(0)
    opt_state = jstate.opt_state
    for _ in range(2):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        _, opt_state = tx.update(grads, opt_state, params)
    adam = opt_state[0]
    arrays = {
        "params": params,
        "mu": jax.tree.map(np.asarray, adam.mu),
        "nu": jax.tree.map(np.asarray, adam.nu),
        "count": int(adam.count),
        "step": 7,
    }
    state = train_state_from_jax_arrays(arrays, tmodel, LRATE, device="cpu")
    assert state.step == 7
    back = jax_arrays_from_train_state(state, tmodel)
    assert back["count"] == 2 and back["step"] == 7
    for key in ("params", "mu", "nu"):
        for name, g, want in _leaf_pairs(back[key], arrays[key]):
            np.testing.assert_array_equal(g, want, err_msg=f"{key}{name}")


# (h) train() end to end on the CPU


@pytest.mark.parametrize("no_batching", [True, False])
def test_train_runs_on_cpu(tmp_path, no_batching, capsys):
    scene = make_scene(n_train=2, n_test=1, H=12, W=12)
    cfg = tconfig.NeRFConfig(
        basedir=str(tmp_path), expname="tiny", netwidth=W, netwidth_fine=W,
        N_samples=8, N_importance=8, N_rand=32, use_viewdirs=True, white_bkgd=True,
        no_batching=no_batching, precrop_iters=2, n_iters=3, i_print=1, i_img=0,
        i_weights=0, i_testset=0, i_video=0, data_axis=1, dataset_type="blender",
    )
    result = train(cfg, scene, device="cpu")
    assert [h[0] for h in result.history] == [1, 2, 3]
    assert all(np.isfinite(h[1]) and np.isfinite(h[2]) for h in result.history)
    assert result.state.step == 3
    assert "[TRAIN] Iter: 3" in capsys.readouterr().out
    assert (tmp_path / "tiny" / "args.txt").exists()


def test_train_runs_fused_render_on_cpu(tmp_path, monkeypatch):
    """``--fused_render`` trains: both levels (S = 8 and 16) take the
    fused-render path, K5/K6's plain versions on the CPU, as nerf_tpu's
    factory and renderer choose it."""
    from nerf_tpu_torch.experimental import fused_render

    scene = make_scene(n_train=2, n_test=1, H=12, W=12)
    cfg = tconfig.NeRFConfig(
        basedir=str(tmp_path), expname="tiny", netwidth=W, netwidth_fine=W,
        N_samples=8, N_importance=8, N_rand=32, use_viewdirs=True, white_bkgd=True,
        raw_noise_std=0.5, fused_render=True, n_iters=3, i_print=1, i_img=0, i_weights=0,
        i_testset=0, i_video=0, data_axis=1, dataset_type="blender",
    )
    assert tfactory.make_model(cfg).fused_render == jfactory.make_model(cfg).fused_render is True
    calls = []
    real = fused_render.fused_render_bwd_reference
    monkeypatch.setattr(fused_render, "fused_render_bwd_reference",
                        lambda *a: calls.append(a[4].shape[-1]) or real(*a))
    result = train(cfg, scene, device="cpu")
    assert [h[0] for h in result.history] == [1, 2, 3]
    assert all(np.isfinite(h[1]) and np.isfinite(h[2]) for h in result.history)
    assert calls == [16, 8] * 3  # each step: the fine level's backward, then the coarse's


def test_train_raises_on_what_is_not_ported(tmp_path):
    """Nothing of train() is left unported. data_axis=2 without a process
    group of 2 ranks raises, naming the CLI and the launcher that start
    them (tests/test_torch_port_parallel.py trains over ranks). With no
    scene given, train() loads the config's scene with every dataset type,
    llff's loader among them (on a directory with no scene it raises for
    the missing file); the cadences, ft_path and trace run
    (tests/test_torch_port_cli.py), the loaders are
    tests/test_torch_port_data.py's."""
    scene = make_scene(n_train=2, n_test=1, H=8, W=8)
    cfg = tconfig.NeRFConfig(basedir=str(tmp_path), n_iters=2, data_axis=1)
    with pytest.raises(ValueError, match=r"cli\.train.*parallel\.distributed\.launch"):
        train(dataclasses.replace(cfg, data_axis=2), scene, device="cpu")
    with pytest.raises(FileNotFoundError, match="poses_bounds.npy"):
        train(dataclasses.replace(cfg, dataset_type="llff", datadir=str(tmp_path / "none")),
              device="cpu")


# (f) a wide configuration (ROADMAP C.3): W = 384, which the W <= 256 tile
# is not built for, through render_rays and a train step


def test_wide_render_rays_and_train_step_match_jax():
    """At 8x384 with 10/4 octaves both packages run their fused raygen
    branch on both levels (nerf_tpu's Pallas K1/K4 in interpret mode; on
    the CPU the port's plain versions, which the card's K1w/K4w hold to):
    render_rays' maps in eval and one train step's loss and updates, with
    test_train_steps_match_jax's bounds."""
    from test_torch_port_fused_mlp import _wide_nets

    nets_j, nets_t = {}, {}
    for k, seed in (("coarse", 0), ("fine", 1)):
        params, net, (jcfg, jpp, jpv), (cfg, pp, pv) = _wide_nets(384, 10, 4, seed)
        nets_j[k], nets_t[k] = params, net
    jmodel = JNeRFModel(jpp, jpv, jcfg, jcfg, "float32", fused=True)
    tmodel = NeRFModel(pp, pv, cfg, cfg, "float32", fused=True)
    jrs, trs = _settings()
    (ro, rd, vd, near, far, target), ov = _batch(30)
    with torch.no_grad():
        out = tr.render_rays(nets_t, tmodel, trs.eval_mode(),
                             *(torch.from_numpy(a) for a in (ro, rd, vd, near, far)),
                             overrides={"u": torch.from_numpy(ov["u"])})
    ref = jr.render_rays(nets_j, jmodel, jrs.eval_mode(),
                         *(jnp.asarray(a) for a in (ro, rd, vd, near, far)),
                         overrides={"u": jnp.asarray(ov["u"])})
    for k in ("rgb_map", "disp_map", "acc_map"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    core = jax.jit(jstep.make_train_step_core(jmodel, jrs, LRATE, LRATE_DECAY))
    jstate = jstep.init_train_state(nets_j, LRATE, LRATE_DECAY)
    state = tstep.init_train_state(nets_t, LRATE)
    step = tstep.make_train_step(tmodel, trs, LRATE, LRATE_DECAY)
    jstate, jaux = core(jstate, *(jnp.asarray(a) for a in (ro, rd, near, far, target)),
                        {k: jnp.asarray(v) for k, v in ov.items()})
    aux = step(state, *(torch.from_numpy(a) for a in (ro, rd, near, far, target)),
               overrides={k: torch.from_numpy(v) for k, v in ov.items()})
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    got = {k: jax_params_from_state_dict(net.state_dict(), cfg) for k, net in state.nets.items()}
    for (name, g, want), (_, p0, _) in zip(
        _leaf_pairs(got, jstate.params), _leaf_pairs(nets_j, jstate.params)
    ):
        assert np.abs(g - want).max() <= 4 * LRATE, name
        err = np.linalg.norm((g - p0) - (want - p0)) / np.linalg.norm(want - p0)
        assert err <= UPDATE_TOL, (name, err)


# (i) the fused loop (fuse_steps, ROADMAP A.3): chunks of k steps, on the
# CPU the graph's plain version (train/graph.py runs the k steps eagerly)


@pytest.fixture
def one_torch_thread():
    """Tiny ops: on torch's default thread pool beside other busy test
    processes they wait on the pool far longer than they compute (as
    tests/test_torch_port_cli.py's fixture says)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fuse_cfg(tmp_path, **kw):
    base = dict(basedir=str(tmp_path), expname="fuse", dataset_type="blender", N_rand=64,
                N_samples=8, N_importance=8, netdepth=2, netwidth=32, netdepth_fine=2,
                netwidth_fine=32, use_viewdirs=True, white_bkgd=True, n_iters=36, i_print=12,
                i_img=0, i_weights=0, i_testset=0, i_video=0, seed=3, data_axis=1,
                compute_dtype="float32")
    base.update(kw)
    return tconfig.NeRFConfig(**base)


@pytest.fixture(scope="module")
def fuse_scene():
    return make_scene(H=20, W=20, n_train=4, n_test=1, seed=2)


@pytest.mark.parametrize("policy,chunks", [
    # chunks 1-5, 7-11, 13-17, 18-22, 25-29, 30-34 (step 6 the crop's last)
    (dict(no_batching=True, precrop_iters=7, precrop_frac=0.5), 6),
    # the precrop boundary (step 10, the first full-frame step) falls as the
    # last step of a would-be chunk [6..10]: 1-5, then 6..10 alone, 11-15,
    # 16-20; an i_print of 5
    (dict(no_batching=True, precrop_iters=10, precrop_frac=0.5, i_print=5, n_iters=20), 3),
    # 1,600 rays, 64 a step: the chunks cross epoch wraps
    (dict(no_batching=False), 6),
], ids=["crop7", "crop10", "batching"])
def test_fused_loop_matches_per_step_loop(tmp_path, fuse_scene, monkeypatch, policy, chunks,
                                          one_torch_thread):
    """train() with fuse_steps = 5 against fuse_steps = 1 (tests/test_train.py's
    fused-scan test at its sizes): the same history and parameters bit for
    bit, for both policies, across the precrop boundary and an i_print that
    5 does not divide; chunks of 5 steps, never across an event."""
    made = []
    for cls in (tdata.BatchedRaySampler, tdata.ImageRaySampler):
        real = cls.advance
        monkeypatch.setattr(cls, "advance", lambda self, k, real=real: made.append(k) or real(self, k))
    runs = {}
    for fuse in (1, 5):
        made.clear()
        result = train(_fuse_cfg(tmp_path / f"f{fuse}", fuse_steps=fuse, **policy), fuse_scene,
                       device="cpu")
        runs[fuse] = (result, list(made))
    (one, no_chunks), (five, five_chunks) = runs[1], runs[5]
    assert no_chunks == [] and five_chunks == [5] * chunks
    assert len(one.history) >= 3 and one.history == five.history
    assert one.state.step == five.state.step
    for level in ("coarse", "fine"):
        for (name, a), b in zip(one.state.nets[level].named_parameters(),
                                five.state.nets[level].parameters()):
            assert torch.equal(a, b), (level, name)
    opt1, opt5 = one.state.optimizer, five.state.optimizer
    for p1, p5 in zip(opt1.param_groups[0]["params"], opt5.param_groups[0]["params"]):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt1.state[p1][key], opt5.state[p5][key]), key


def test_batched_window_matches_next_batch_across_an_epoch_wrap(scene):
    """The window builder: k steps' indices [k, n_rand], gathered, are the
    batches of k next_batch calls across two epoch wraps (the tail, then a
    new permutation from the generator); advance(k) leaves the sampler as
    those calls did, and building a window alone moves nothing."""
    n_rand, k = 64, 25  # 960 rays an epoch: 15 steps, the 25 cross two wraps
    ref = tdata.BatchedRaySampler(scene, n_rand, torch.Generator().manual_seed(4), device="cpu")
    got = tdata.BatchedRaySampler(scene, n_rand, torch.Generator().manual_seed(4), device="cpu")
    for _ in range(3):
        ref.next_batch()
        got.next_batch()
    want = [torch.cat(ref.next_batch(), -1) for _ in range(k)]
    state = (got.perm.clone(), got.i_batch, got.generator.get_state())
    got.window(k)
    assert torch.equal(got.perm, state[0]) and got.i_batch == state[1]
    assert torch.equal(got.generator.get_state(), state[2])
    window = got.window(k)
    assert window.shape == (k, n_rand)
    for j in range(k):
        assert torch.equal(torch.cat(got.gather(window[j]), -1), want[j]), j
    got.advance(k)
    assert torch.equal(got.perm, ref.perm) and got.i_batch == ref.i_batch
    assert torch.equal(got.generator.get_state(), ref.generator.get_state())
    assert torch.equal(torch.cat(got.next_batch(), -1), torch.cat(ref.next_batch(), -1))


def test_fused_chunks_and_cap_line_match_nerf_tpu(tmp_path, fuse_scene, monkeypatch, capsys,
                                                  one_torch_thread):
    """The same config through both packages' train(): the same chunk
    sizes (each sampler's advance(k)) and the same [FUSE] cap line, here
    with fuse_steps 50 capped to i_print 5 and the batching policy (two
    chunks, steps 11 and 12 one by one; the port's test above holds its
    precrop chunks)."""
    from nerf_tpu.train.loop import train as jtrain

    kw = dict(fuse_steps=50, i_print=5, n_iters=12, no_batching=False)
    runs = {}
    for name, pkg, run in (("port", tdata, lambda c: train(c, fuse_scene, device="cpu")),
                           ("nerf_tpu", jdata, lambda c: jtrain(
                               jconfig.NeRFConfig(**dataclasses.asdict(c)), scene=fuse_scene))):
        chunks = []
        real = pkg.BatchedRaySampler.advance
        monkeypatch.setattr(pkg.BatchedRaySampler, "advance",
                            lambda self, k, real=real: chunks.append(k) or real(self, k))
        run(_fuse_cfg(tmp_path / name, **kw))
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[FUSE]")]
        runs[name] = (chunks, lines)
    assert runs["port"] == runs["nerf_tpu"] == ([5, 5],
                                                ["[FUSE] fuse_steps=50 capped to 5 "
                                                 "(smallest cadence interval)"])
