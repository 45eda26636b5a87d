"""The port's entry path against nerf_tpu, on the CPU: the PNG codec, the
blender loader, the ``.tar`` checkpoints both ways, resume, ``train()``
with every cadence and the trace, and the two CLIs.

Scenes are tests/synthetic_scene.py's, written to disk at 32x32 (the
CLI runs take configs/lego.txt's half_res: 16x16 frames). The
card's run of the same path is chip_smoke.py's phases 19 and 20.
"""

import dataclasses
import os
import re
import struct
import sys
import zlib
from pathlib import Path

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.data.blender import load_blender_scene as jload_blender_scene
from nerf_tpu.models import factory as jfactory
from nerf_tpu.models.torch_import import export_torch_checkpoint, train_state_from_torch_checkpoint
from nerf_tpu.render.renderer import make_frame_renderer as jmake_frame_renderer
from nerf_tpu.train import loop as jloop
from nerf_tpu.train import step as jstep
from nerf_tpu.utils.metrics import img2mse as jimg2mse
from nerf_tpu.utils.metrics import mse2psnr as jmse2psnr
from nerf_tpu_torch import config as tconfig
from nerf_tpu_torch.cli import render as cli_render
from nerf_tpu_torch.cli import train as cli_train
from nerf_tpu_torch.data.blender import load_blender_scene
from nerf_tpu_torch.data.scene import Scene, default_intrinsics
from nerf_tpu_torch.models import factory as tfactory
from nerf_tpu_torch.models.convert import jax_arrays_from_train_state
from nerf_tpu_torch.render.renderer import make_frame_renderer as tmake_frame_renderer
from nerf_tpu_torch.train import loop as tloop
from nerf_tpu_torch.train.loop import load_scene, train
from nerf_tpu_torch.train.step import init_train_state
from nerf_tpu_torch.utils import checkpoint
from nerf_tpu_torch.utils.io import read_png, write_png

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synthetic_scene import write_blender_dataset  # noqa: E402

LRATE, LRATE_DECAY = 5e-4, 500
WIDTH = 32  # a narrow MLP: these tests check the loop, not the kernels


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The loop's ops are tiny (16x16 frames, a 32-wide MLP): with torch's
    default thread pool beside other busy test processes, they wait on the
    pool far longer than they compute (the cadence test: ~8 s with one
    thread, minutes with eight, on a loaded 8-core host)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (a) the PNG codec


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """An 8-bit PNG of ``img`` [H, W, C] with every row under filter
    ``ftype`` (the PNG specification's predictors, from the raw bytes)."""
    H, W, C = img.shape
    x = img.reshape(H, W * C).astype(np.int32)
    a = np.pad(x, ((0, 0), (C, 0)))[:, : W * C]  # left
    b = np.pad(x, ((1, 0), (0, 0)))[:H]  # up
    c = np.pad(b, ((0, 0), (C, 0)))[:, : W * C]  # up-left
    if ftype == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        pred = [np.zeros_like(x), a, b, (a + b) // 2][ftype]
    rows = np.concatenate([np.full((H, 1), ftype), (x - pred) & 255], 1).astype(np.uint8)

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    colour = {3: 2, 4: 6}[C]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def _png_filters(path) -> set:
    blob, pos, idat, header = open(path, "rb").read(), 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        kind, data = blob[pos + 4 : pos + 8], blob[pos + 8 : pos + 8 + n]
        header = struct.unpack(">IIBBBBB", data) if kind == b"IHDR" else header
        idat += [data] if kind == b"IDAT" else []
        pos += 12 + n
    W, H, _, colour = header[:4]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(H, -1)[:, 0].tolist())


def _test_image(H, W, C, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    planes = [xx * 255 // W, yy * 255 // H, (xx * yy) % 256, rng.integers(0, 256, (H, W))]
    img = np.stack(planes[:C], -1).astype(np.uint8)
    img[: H // 3] = rng.integers(0, 256, (H // 3, W, C))  # noise rows: other filters win
    return img


@pytest.mark.parametrize("channels", [3, 4])
def test_read_png_matches_imageio(tmp_path, channels):
    img = _test_image(61, 67, channels, seed=channels)
    seen = set()
    path = tmp_path / "pillow.png"
    imageio.imwrite(path, img)  # Pillow's adaptive filters
    seen |= _png_filters(path)
    np.testing.assert_array_equal(read_png(str(path)), imageio.imread(path))
    for ftype in range(5):  # each filter type on every row
        path = tmp_path / f"f{ftype}.png"
        path.write_bytes(_filtered_png(img, ftype))
        seen |= _png_filters(path)
        np.testing.assert_array_equal(read_png(str(path)), imageio.imread(path))
        np.testing.assert_array_equal(read_png(str(path)), img)
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 1), (13, 17, 2), (13, 17, 3), (13, 17, 4)])
def test_write_png_round_trip(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "img.png")
    write_png(path, img)
    want = img[..., 0] if img.ndim == 3 and img.shape[-1] == 1 else img
    np.testing.assert_array_equal(read_png(path), want)
    np.testing.assert_array_equal(imageio.imread(path), want)


# (b) the blender loader


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("blender")
    write_blender_dataset(str(d), n_train=3, n_val=2, n_test=3, H=32, W=32)
    return str(d)


@pytest.mark.parametrize("half_res", [False, True])
@pytest.mark.parametrize("testskip", [1, 2])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_blender_scene_matches_jax(blender_dir, half_res, testskip, white_bkgd):
    ours = load_blender_scene(blender_dir, half_res, testskip, white_bkgd)
    ref = jload_blender_scene(blender_dir, half_res, testskip, white_bkgd)
    for field in ("images", "poses", "render_poses", "K", "i_train", "i_val", "i_test"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field), err_msg=field)
    assert ours.hwf == ref.hwf and (ours.near, ours.far) == (ref.near, ref.far)
    assert ours.images.dtype == np.float32 and ours.images.shape[-1] == 3


@pytest.mark.parametrize("dataset_type", ["llff", "deepvoxels", "LINEMOD"])
def test_unported_datasets_raise(tmp_path, dataset_type):
    """load_scene and train() dispatch llff, deepvoxels and LINEMOD to their
    loaders: on a directory with no scene the loader raises for the missing
    files (tests/test_torch_port_data.py loads real scenes); an unknown type
    raises ValueError."""
    cfg = tconfig.NeRFConfig(dataset_type=dataset_type, datadir=str(tmp_path / "none"),
                             basedir=str(tmp_path), data_axis=1)
    with pytest.raises(FileNotFoundError):
        load_scene(cfg)
    with pytest.raises(FileNotFoundError):
        train(cfg, device="cpu")
    with pytest.raises(ValueError, match="Unknown dataset type"):
        load_scene(dataclasses.replace(cfg, dataset_type=dataset_type.upper() + "_X"))


# (c) the .tar both ways


def _cfg(use_viewdirs, n_importance, **kw):
    return tconfig.NeRFConfig(netwidth=WIDTH, netwidth_fine=WIDTH, use_viewdirs=use_viewdirs,
                              N_importance=n_importance, N_samples=8, lrate=LRATE,
                              lrate_decay=LRATE_DECAY, **kw)


def _port_state(cfg, seed=0, updates=2, step=7):
    """A port train state with Adam moments from ``updates`` random grads."""
    model = tfactory.make_model(cfg)
    state = init_train_state(tfactory.init_nets(model, seed, "cpu"), LRATE, start_step=step)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(updates):
        for net in state.nets.values():
            for name, p in net.named_parameters():
                used = cfg.use_viewdirs or not name.startswith("views_linears")
                p.grad = torch.randn(p.shape, generator=gen) if used else None
        state.optimizer.step()
    return model, state


def _assert_arrays_equal(got, want):
    assert got["step"] == want["step"] and got["count"] == want["count"]
    for key in ("params", "mu", "nu"):
        flat_g, tree_g = jax.tree.flatten(got[key])
        flat_w, tree_w = jax.tree.flatten(want[key])
        assert tree_g == tree_w, key
        for g, w in zip(flat_g, flat_w):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=key)


def _jax_arrays(jstate) -> dict:
    adam = jstate.opt_state[0]
    return {"params": jax.device_get(jstate.params), "mu": jax.device_get(adam.mu),
            "nu": jax.device_get(adam.nu), "count": int(adam.count), "step": int(jstate.step)}


@pytest.mark.parametrize("use_viewdirs", [True, False])
@pytest.mark.parametrize("n_importance", [8, 0])
def test_port_tar_loads_in_nerf_tpu(tmp_path, use_viewdirs, n_importance):
    cfg = _cfg(use_viewdirs, n_importance)
    model, state = _port_state(cfg)
    path = checkpoint.save_checkpoint(str(tmp_path), "exp", state)
    assert os.path.basename(path) == "000007.tar"
    tar = torch.load(path, weights_only=False)
    # the reference layout: views_linears.0 always (zeros without viewdirs),
    # one optimizer entry per parameter, coarse first
    assert "views_linears.0.weight" in tar["network_fn_state_dict"]
    assert ("network_fine_state_dict" in tar) == (n_importance > 0)
    n_params = sum(len(list(n.parameters())) for n in state.nets.values())
    assert sorted(tar["optimizer_state_dict"]["state"]) == list(range(n_params))
    if not use_viewdirs:
        assert not tar["network_fn_state_dict"]["views_linears.0.weight"].any()
    jstate = train_state_from_torch_checkpoint(path, jfactory.make_model(cfg), LRATE, LRATE_DECAY)
    _assert_arrays_equal(_jax_arrays(jstate), jax_arrays_from_train_state(state, model))
    assert int(jstate.opt_state[1].count) == 2  # the schedule's count is Adam's


@pytest.mark.parametrize("use_viewdirs", [True, False])
@pytest.mark.parametrize("n_importance", [8, 0])
def test_nerf_tpu_export_loads_in_port(tmp_path, use_viewdirs, n_importance):
    cfg = _cfg(use_viewdirs, n_importance)
    jmodel = jfactory.make_model(cfg)
    params = jfactory.init_model_params(jax.random.key(3), jmodel)
    jstate = jstep.init_train_state(params, LRATE, LRATE_DECAY, start_step=5)
    tx = jstep.make_optimizer(LRATE, LRATE_DECAY)
    rng = np.random.default_rng(0)
    opt_state = jstate.opt_state
    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                             params)
        _, opt_state = tx.update(grads, opt_state, params)
    jstate = jstep.TrainState(params=params, opt_state=opt_state, step=jstate.step)
    path = export_torch_checkpoint(str(tmp_path / "exported.tar"), jstate, jmodel)
    if not use_viewdirs:  # nerf_tpu's export omits the unused head (ADVICE.md:3)
        assert "views_linears.0.weight" not in torch.load(path, weights_only=False)[
            "network_fn_state_dict"]
    model = tfactory.make_model(cfg)
    state = checkpoint.load_checkpoint(path, model, LRATE, device="cpu")
    assert state.step == 5
    _assert_arrays_equal(jax_arrays_from_train_state(state, model), _jax_arrays(jstate))


def test_maybe_resume_policy(tmp_path):
    """The reference's policy (run_nerf.py:216-233): the newest .tar, or
    ft_path; nothing with no_reload, ft_path or not (nerf_tpu loads an
    ft_path .tar even with no_reload: ROADMAP C)."""
    cfg = _cfg(True, 8)
    model, fresh = _port_state(cfg, seed=1, updates=0, step=0)
    base = str(tmp_path)

    def resume(**kw):
        return checkpoint.maybe_resume(base, "exp", fresh, model, LRATE, device="cpu", **kw)

    assert resume() is fresh  # nothing saved yet
    for step in (10, 20):
        checkpoint.save_checkpoint(base, "exp", _port_state(cfg, seed=step, step=step)[1])
    other = str(tmp_path / "other.tar")
    torch.save(checkpoint.checkpoint_dict(_port_state(cfg, seed=5, step=5)[1]), other)
    assert [os.path.basename(p) for p in checkpoint.find_checkpoints(base, "exp")] == [
        "000010.tar", "000020.tar"]
    assert resume().step == 20
    assert resume(no_reload=True) is fresh
    assert resume(ft_path=other).step == 5
    assert resume(ft_path=other, no_reload=True) is fresh
    assert resume(ft_path="None").step == 20
    with pytest.raises(ValueError, match="not a .tar"):
        resume(ft_path=str(tmp_path / "ckpt_000010"))


# (d) train() and the CLIs end to end


@pytest.mark.parametrize("render_factor", [0, 2])
def test_render_path_uses_the_scene_intrinsics(render_factor):
    """ROADMAP C.5: render_path renders with scene.K (LINEMOD's comes from
    its json, off centre), its first two rows divided by render_factor, as
    the frame renderer of that K does; nerf_tpu's render_path builds a
    centred K there (nerf_tpu/train/loop.py:102), which the port does not
    copy."""
    H, W, focal = 12, 16, 14.0
    K = np.array([[focal, 0, 0.5 * W + 3.5], [0, focal, 0.5 * H - 2.5], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * 2)
    poses[:, 2, 3] = 4.0
    scene = Scene(images=np.zeros((2, H, W, 3), np.float32), poses=poses, render_poses=poses,
                  hwf=(H, W, focal), K=K, i_train=np.arange(2), i_val=np.arange(0),
                  i_test=np.arange(0), near=2.0, far=6.0)
    cfg = _cfg(True, 8, dataset_type="blender")
    model = tfactory.make_model(cfg)
    nets = tfactory.init_nets(model, 0, "cpu")
    rs = tloop.render_settings_from_config(cfg)
    rgbs, _ = tloop.render_path(nets, model, rs, scene, poses, 64, render_factor, device="cpu")
    f = render_factor or 1
    want_k = K.copy()
    want_k[:2] /= f
    for k, centred in ((want_k, False), (default_intrinsics(H // f, W // f, focal / f), True)):
        frame = tmake_frame_renderer(model, rs.eval_mode(), H // f, W // f, k, 2.0, 6.0,
                                     chunk=64, device="cpu")
        same = all(np.array_equal(rgb, frame(nets, pose)["rgb_map"].numpy())
                   for rgb, pose in zip(rgbs, poses))
        assert same is not centred


def _lego_argv(tmp_path, blender_dir, **over):
    flags = {"config": "configs/lego.txt", "datadir": blender_dir,
             "basedir": str(tmp_path / "logs"), "expname": "tiny", "testskip": 1,
             "netwidth": WIDTH, "netwidth_fine": WIDTH, "N_samples": 8, "N_importance": 8,
             "N_rand": 32, "precrop_iters": 0, "fused_kernels": False, "data_axis": 1,
             "n_iters": 16, "i_print": 4, "i_img": 8, "i_weights": 8, "i_testset": 16,
             "i_video": 16, "trace": True}
    flags.update(over)
    repo = Path(__file__).resolve().parents[1]
    flags["config"] = str(repo / flags["config"])
    return [f"--{k}={v}" for k, v in flags.items()]


def test_train_every_cadence_on_cpu(tmp_path, blender_dir, capsys):
    """Every cadence and the trace fire and write their files; the trace's
    4 extra steps move state.step (not i), so the last .tar is named 20 at
    i = 16, as nerf_tpu names it; the holdout PSNR is nerf_tpu's PSNR of the
    same view rendered from the same weights."""
    cfg = tconfig.load_config(_lego_argv(tmp_path, blender_dir))
    result = train(cfg, device="cpu")
    out = capsys.readouterr().out
    expdir = tmp_path / "logs" / "tiny"
    assert result.state.step == 16 + 4
    assert [h[0] for h in result.history] == [4, 8, 12, 16]
    assert sorted(f for f in os.listdir(expdir) if f.endswith(".tar")) == [
        "000008.tar", "000020.tar"]
    assert (expdir / "args.txt").exists() and (expdir / "config.txt").read_text() == \
        Path(cfg.config).read_text()
    assert (expdir / "trace" / "trace.json").stat().st_size > 0
    assert "[TRACE] profile written" in out
    test_pngs = sorted(os.listdir(expdir / "testset_000016"))
    assert test_pngs == ["000.png", "001.png", "002.png"]
    assert read_png(str(expdir / "testset_000016" / "000.png")).shape == (16, 16, 3)  # half_res
    for kind in ("rgb", "disp"):
        frames = expdir / f"tiny_spiral_000016_{kind}_frames"
        assert len(os.listdir(frames)) == 40 or (expdir / f"tiny_spiral_000016_{kind}.mp4").exists()
    evals = re.findall(r"\[EVAL\] Iter: (\d+) holdout view (\d+) PSNR: (\S+)", out)
    assert [(int(i), int(v)) for i, v, _ in evals] == [(8, 4), (16, 3)]  # i_val = [3, 4], cycled
    assert "[EVAL] mean PSNR over 3 views" in out

    # the last holdout eval (i = 16) used the final weights
    jmodel = jfactory.make_model(cfg)
    arrays = jax_arrays_from_train_state(result.state, tfactory.make_model(cfg))
    scene = jloop.load_scene(cfg)
    rs = jloop.render_settings_from_config(cfg).eval_mode()
    frame = jmake_frame_renderer(jmodel, rs, scene.H, scene.W, scene.K, scene.near, scene.far,
                                 chunk=cfg.chunk)
    view = int(evals[-1][1])
    rgb = frame(arrays["params"], jnp.asarray(scene.poses[view][:3, :4]))["rgb_map"]
    want = float(jmse2psnr(jimg2mse(rgb, jnp.asarray(scene.images[view]))))
    assert abs(float(evals[-1][2]) - want) <= 1e-3  # printed to 3 decimals


def test_cli_train_then_render_on_cpu(tmp_path, blender_dir, capsys):
    argv = _lego_argv(tmp_path, blender_dir, n_iters=8, i_img=0, i_testset=0, i_video=0,
                      trace=False)
    trained = cli_train.main(argv, device="cpu")
    resumed = cli_train.main(argv[:-1] + ["--trace=False", "--n_iters=12", "--i_weights=12"],
                             device="cpu")
    assert resumed.state.step == 12 and [h[0] for h in resumed.history] == [12]
    rendered = cli_render.main(argv + ["--render_test"], device="cpu")
    assert rendered.state.step == 12
    for a, b in zip(rendered.state.nets["fine"].parameters(), resumed.state.nets["fine"].parameters()):
        assert torch.equal(a, b)
    assert trained.state.step == 8
    savedir = tmp_path / "logs" / "tiny" / "renderonly_test_000012"
    assert sorted(os.listdir(savedir))[:3] == ["000.png", "001.png", "002.png"]
    assert (savedir / "video_frames").is_dir() or (savedir / "video.mp4").exists()
    psnr = re.findall(r"\[EVAL\] mean PSNR over 3 views: (\S+)", capsys.readouterr().out)
    assert len(psnr) == 1 and np.isfinite(float(psnr[0]))
