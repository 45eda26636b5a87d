"""The port's renderer, end to end, against nerf_tpu on the CPU,
both with the fused branch on (nerf_tpu runs its Pallas kernel in interpret
mode; the port takes the kernel's plain version), plus the port's import
rules."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.geom.poses import pose_spherical as jpose_spherical
from nerf_tpu.models.embedding import PosEncConfig as JPosEnc
from nerf_tpu.models.nerf_mlp import MLPConfig as JMLPConfig
from nerf_tpu.models.nerf_mlp import init_params
from nerf_tpu.render import renderer as jr
from nerf_tpu.render.network import NeRFModel as JNeRFModel
from nerf_tpu_torch.data.scene import Scene, default_intrinsics
from nerf_tpu_torch.geom.poses import spherical_render_poses
from nerf_tpu_torch.models.convert import state_dict_from_jax_params
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.render import renderer as tr
from nerf_tpu_torch.render.network import NeRFModel
from nerf_tpu_torch.train.loop import render_path

REPO = Path(__file__).resolve().parents[1]
W = 128  # the fused kernels need a multiple of 128
N_SAMPLES, N_IMPORTANCE = 16, 24  # coarse and fine (40) both take the fused branch
F32_TOL = 1e-5
# Fine-level raw is evaluated at importance samples drawn from the coarse
# weights; the two packages' CDF sums round differently, so a fine depth may
# move by an ulp (~5e-7 at z~4). The top posenc octave (2^9, times |rays_d|)
# turns that into ~4e-4 rad of phase, which moves raw by up to ~1e-4; the
# maps, which integrate raw over samples, stay within F32_TOL.
FINE_RAW_TOL = 1e-4
CFG, JCFG = MLPConfig(width=W), JMLPConfig(width=W)
MODEL = NeRFModel(PosEncConfig(10), PosEncConfig(4), CFG, CFG, "float32", fused=True)
JMODEL = JNeRFModel(JPosEnc(10), JPosEnc(4), JCFG, JCFG, "float32", fused=True)


@pytest.fixture(scope="module")
def nets():
    params, port = {}, {}
    for seed, level in enumerate(("coarse", "fine")):
        params[level] = jax.tree.map(np.asarray, init_params(jax.random.key(seed), JCFG))
        port[level] = NeRFMLP(CFG, device="cpu")
        port[level].load_state_dict(state_dict_from_jax_params(params[level], CFG), strict=True)
    return params, port


def _settings(**kw):
    kw = dict(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, white_bkgd=True) | kw
    return jr.RenderSettings(**kw), tr.RenderSettings(**kw)


def _close_maps(out, ref):
    assert set(out) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        o = out[k].numpy()
        assert o.shape == r.shape, k
        tol = FINE_RAW_TOL if k == "raw" else F32_TOL
        np.testing.assert_allclose(o, r, rtol=0, atol=tol, err_msg=k)


def _rays(seed, R):
    rng = np.random.default_rng(seed)
    ro = (rng.standard_normal((R, 3)) * 0.3).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    near, far = np.full(R, 2.0, np.float32), np.full(R, 6.0, np.float32)
    return (ro, rd, vd, near, far), rng


@pytest.mark.parametrize("n_samples,n_importance", [(N_SAMPLES, N_IMPORTANCE), (12, 20)])
def test_render_rays_eval_matches_jax(nets, n_samples, n_importance):
    """(12, 20): 12 coarse samples fail the fused branch's S % 8 guard, so
    the coarse level takes query_raw (nerf_tpu: its points-in kernel); the
    fine level (32) stays fused."""
    params, port = nets
    jrs, trs = _settings(perturb=False, retraw=True, n_samples=n_samples,
                         n_importance=n_importance)
    arrays, _ = _rays(0, 9)
    ref = jr.render_rays(params, JMODEL, jrs, *(jnp.asarray(a) for a in arrays))
    with torch.no_grad():
        out = tr.render_rays(port, MODEL, trs, *(torch.from_numpy(a) for a in arrays))
    assert out["raw"].shape == (9, n_samples + n_importance, 4)
    _close_maps(out, ref)


def test_render_rays_with_overrides_matches_jax(nets):
    """Jitter, both noises and the importance u come from numpy."""
    params, port = nets
    jrs, trs = _settings(perturb=True, raw_noise_std=1.0)
    arrays, rng = _rays(1, 7)
    S_fine = N_SAMPLES + N_IMPORTANCE
    ov = {
        "t_rand": rng.uniform(size=(7, N_SAMPLES)),
        "noise0": rng.standard_normal((7, N_SAMPLES)),
        "u": rng.uniform(size=(7, N_IMPORTANCE)),
        "noise1": rng.standard_normal((7, S_fine)),
    }
    ov = {k: v.astype(np.float32) for k, v in ov.items()}
    ref = jr.render_rays(params, JMODEL, jrs, *(jnp.asarray(a) for a in arrays),
                         overrides={k: jnp.asarray(v) for k, v in ov.items()})
    with torch.no_grad():
        out = tr.render_rays(port, MODEL, trs, *(torch.from_numpy(a) for a in arrays),
                             overrides={k: torch.from_numpy(v) for k, v in ov.items()})
    _close_maps(out, ref)


def test_render_image_matches_jax(nets):
    """A 6x8 frame (H != W catches transposes), chunked unevenly."""
    params, port = nets
    jrs, trs = _settings(perturb=False)
    H, Wd, f = 6, 8, 7.0
    K = default_intrinsics(H, Wd, f)
    c2w = jpose_spherical(30.0, -30.0, 4.0)[:3, :4]
    ref = jr.render_image(params, JMODEL, jrs, H, Wd, K, jnp.asarray(c2w), 2.0, 6.0, chunk=20)
    with torch.no_grad():
        out = tr.render_image(port, MODEL, trs, H, Wd, K, torch.from_numpy(c2w), 2.0, 6.0,
                              chunk=20)
    assert out["rgb_map"].shape == (H, Wd, 3)
    _close_maps(out, ref)


def test_render_image_staticcam_matches_jax(nets):
    """c2w_staticcam: shading from c2w's directions, rays from the static
    camera's (run_nerf.py:105-107), on a 4x6 frame."""
    params, port = nets
    jrs, trs = _settings(perturb=False)
    H, Wd, f = 4, 6, 5.0
    K = default_intrinsics(H, Wd, f)
    c2w = jpose_spherical(30.0, -30.0, 4.0)[:3, :4]
    static = jpose_spherical(-60.0, -20.0, 4.0)[:3, :4]
    ref = jr.render_image(params, JMODEL, jrs, H, Wd, K, jnp.asarray(c2w), 2.0, 6.0, chunk=16,
                          c2w_staticcam=jnp.asarray(static))
    with torch.no_grad():
        out = tr.render_image(port, MODEL, trs, H, Wd, K, torch.from_numpy(c2w), 2.0, 6.0,
                              chunk=16, c2w_staticcam=torch.from_numpy(static))
        moving = tr.render_image(port, MODEL, trs, H, Wd, K, torch.from_numpy(static), 2.0, 6.0,
                                 chunk=16)
    _close_maps(out, ref)
    # the static camera's rays with other view directions: another colour
    assert not torch.allclose(out["rgb_map"], moving["rgb_map"])


def test_render_path_on_cpu(nets, capsys, tmp_path):
    _, port = nets
    _, trs = _settings(perturb=True)
    H = Wd = 4
    poses = spherical_render_poses(40)[:2]
    scene = Scene(images=np.zeros((2, H, Wd, 3), np.float32), poses=poses[:, :3, :4],
                  render_poses=poses, hwf=(H, Wd, 5.0), K=default_intrinsics(H, Wd, 5.0),
                  i_train=np.arange(2), i_val=np.arange(0), i_test=np.arange(0),
                  near=2.0, far=6.0)
    rgbs, disps = render_path(port, MODEL, trs, scene, poses, chunk=10, savedir=str(tmp_path),
                              gt_imgs=np.full((2, H, Wd, 3), 0.5, np.float32), device="cpu")
    assert rgbs.shape == (2, H, Wd, 3) and disps.shape == (2, H, Wd)
    assert np.isfinite(rgbs).all() and np.isfinite(disps).all()
    assert "[EVAL] mean PSNR over 2 views" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["000.png", "001.png"]
    small, _ = render_path(port, MODEL, trs, scene, poses[:1], chunk=10, render_factor=2,
                           gt_imgs=np.zeros((1, H, Wd, 3), np.float32), device="cpu")
    assert small.shape == (1, H // 2, Wd // 2, 3)
    assert "PSNR" not in capsys.readouterr().out  # no gt comparison when downsampled
    # the same frame through render_image: render_path is eval mode, chunked
    with torch.no_grad():
        one = tr.render_image(port, MODEL, trs.eval_mode(), H, Wd, scene.K,
                              torch.from_numpy(poses[1][:3, :4]), 2.0, 6.0)
    np.testing.assert_allclose(rgbs[1], one["rgb_map"].numpy(), rtol=0, atol=1e-6)


def test_frame_renderer_without_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: device=None resolves to it")
    _, trs = _settings(perturb=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.make_frame_renderer(MODEL, trs, 4, 4, default_intrinsics(4, 4, 5.0), 2.0, 6.0)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_nerf_tpu():
    files = sorted((REPO / "nerf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    parallel = REPO / "nerf_tpu_torch" / "parallel"
    port = REPO / "nerf_tpu_torch"
    assert {parallel / "mesh.py", parallel / "distributed.py", parallel / "multi_scene.py",
            parallel / "tensor_parallel.py", port / "cli" / "train_multi.py",
            port / "tools" / "make_multi_scenes.py"} <= set(files)
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "nerf_tpu"), f"{path}: imports {mod}"
