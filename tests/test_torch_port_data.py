"""The port's scene formats against nerf_tpu, on the CPU: the LLFF pose
pipeline, the native resampler, the LLFF, DeepVoxels and LINEMOD loaders,
the procedural field and its ground-truth renderer, the four scene
writers, the Keras weight import, and ``train()`` on an LLFF scene with NDC
rays and the batching sampler.

Both packages get the same seeded numpy inputs. Scenes are a few views of
16-32 pixels. The card's run of the same path is chip_smoke.py's phases
21-23.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.data import synth as jsynth
from nerf_tpu.data.deepvoxels import load_deepvoxels_scene as jload_dv
from nerf_tpu.data.linemod import load_linemod_scene as jload_linemod
from nerf_tpu.data.llff import load_llff_data as jload_llff_data
from nerf_tpu.data.llff import load_llff_scene as jload_llff_scene
from nerf_tpu.geom import poses as jposes
from nerf_tpu.models.keras_import import params_from_keras as jparams_from_keras
from nerf_tpu.models.nerf_mlp import MLPConfig as JMLPConfig
from nerf_tpu.models.nerf_mlp import apply_mlp as japply_mlp
from nerf_tpu.native import resize as jresize
from nerf_tpu_torch import config as tconfig
from nerf_tpu_torch.data import synth
from nerf_tpu_torch.data.deepvoxels import load_deepvoxels_scene
from nerf_tpu_torch.data.linemod import load_linemod_scene
from nerf_tpu_torch.data.llff import load_llff_data, load_llff_scene
from nerf_tpu_torch.geom import poses
from nerf_tpu_torch.models.convert import state_dict_from_jax_params
from nerf_tpu_torch.models.keras_import import params_from_keras
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.native import resize
from nerf_tpu_torch.tools import (
    make_benchmark_scene,
    make_deepvoxels_scene,
    make_linemod_scene,
    make_llff_benchmark_scene,
)
from nerf_tpu_torch.train.loop import load_scene, train
from nerf_tpu_torch.utils.io import read_png, write_png

SCENE_FIELDS = ("images", "poses", "render_poses", "K", "i_train", "i_val", "i_test")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny ops: torch's thread pool beside other busy test processes waits
    far longer than it computes (as in test_torch_port_cli.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_scenes_equal(ours, ref, image_atol=0.0):
    for field in SCENE_FIELDS:
        got, want = getattr(ours, field), getattr(ref, field)
        if field == "images" and image_atol:
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=image_atol, err_msg=field)
        else:
            np.testing.assert_array_equal(got, want, err_msg=field)
    assert ours.hwf == ref.hwf and (ours.near, ours.far) == (ref.near, ref.far)
    if ref.bds is None:
        assert ours.bds is None
    else:
        np.testing.assert_array_equal(ours.bds, ref.bds)


# (a) the LLFF pose pipeline


def _llff_poses(n=7, seed=0):
    """Forward-facing-ish [n, 3, 5] poses (rotations near identity, hwf
    column) and their [n, 2] bounds."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        fwd = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), 1.0])
        frame = poses.viewmatrix(fwd, [0.0, 1.0, 0.0],
                                 [rng.uniform(-0.5, 0.5), rng.uniform(-0.4, 0.4),
                                  4.0 + rng.uniform(-0.2, 0.2)])
        out.append(np.concatenate([frame, [[24.0], [32.0], [30.0]]], 1))
    bds = np.stack([rng.uniform(2.0, 2.5, n), rng.uniform(5.5, 6.5, n)], -1)
    return np.asarray(out, np.float32), bds.astype(np.float32)


def _spiral(mod, zflat):
    p, bds = _llff_poses()
    c2w = mod.poses_avg(p)
    up = mod.normalize(p[:, :3, 1].sum(0))
    rads = np.percentile(np.abs(p[:, :3, 3]), 90, 0)
    close_depth = bds.min() * 0.9
    rots, n = 2, 120
    if zflat:  # load_llff_data's path_zflat branch
        c2w[:3, 3] = c2w[:3, 3] - close_depth * 0.1 * c2w[:3, 2]
        rads[2], rots, n = 0.0, 1, 60
    return np.asarray(mod.render_path_spiral(c2w, up, rads, 3.0, 0.2, 0.5, rots, n))


POSE_CASES = {
    "viewmatrix": lambda m: m.viewmatrix([0.1, -0.2, 1.0], [0.05, 1.0, 0.1], [0.3, 0.2, 4.0]),
    "poses_avg": lambda m: m.poses_avg(_llff_poses()[0]),
    "recenter_poses": lambda m: m.recenter_poses(_llff_poses()[0]),
    "render_path_spiral": lambda m: _spiral(m, zflat=False),
    "render_path_spiral_zflat": lambda m: _spiral(m, zflat=True),
    "spherify_poses": lambda m: np.concatenate(
        [a.reshape(-1) for a in m.spherify_poses(*_llff_poses())]),
}


@pytest.mark.parametrize("case", sorted(POSE_CASES))
def test_llff_poses_match_jax(case):
    """numpy on both sides, the same operations: bit-equal."""
    got, want = POSE_CASES[case](poses), POSE_CASES[case](jposes)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# (b) the native resampler


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("factor", [2, 3])
def test_area_downsample_matches_nerf_tpu(dtype, factor):
    """37 x 23 does not divide by 2 or 3: the trailing rows/columns drop."""
    rng = np.random.default_rng(factor)
    img = rng.integers(0, 256, (37, 23, 3)).astype(dtype)
    got = resize.area_downsample(img, factor)
    assert got.shape == (37 // factor, 23 // factor, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jresize.area_downsample(img, factor))


@pytest.mark.parametrize("size", [(12, 8), (33, 21), (96, 64)])
def test_lanczos_resize_matches_nerf_tpu(size):
    """The same source and g++ flags as nerf_tpu's library: equal sums."""
    img = np.random.default_rng(7).random((96, 64, 3)).astype(np.float32) * 255.0
    np.testing.assert_array_equal(resize.lanczos_resize(img, *size),
                                  jresize.lanczos_resize(img, *size))


@pytest.mark.parametrize("source", ["missing", "broken"])
def test_resize_build_failure_raises(tmp_path, source):
    src = tmp_path / "resize.cpp"
    if source == "broken":
        src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="resize.cpp"):
        resize.build(src)


# (c) the LLFF loader


def _write_llff(basedir, n=6, H=24, W=32, f=30.0, seed=0, ext="png"):
    """A tiny LLFF scene (tests/test_config_and_data.py's layout):
    cameras near z = 4 looking at points near the origin (so that
    spherify's view axes meet), poses_bounds.npy in the disk convention,
    RGB views."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(basedir, "images"))
    poses_bounds = np.zeros((n, 17))
    for i in range(n):
        pos = np.array([rng.uniform(-0.6, 0.6), rng.uniform(-0.4, 0.4), 4 + rng.uniform(-0.1, 0.1)])
        look = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), 0.0])
        c2w = poses.viewmatrix(pos - look, [0.0, 1.0, 0.0], pos)
        m = np.concatenate([-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:3], c2w[:, 3:4],
                            np.array([[H], [W], [f]])], 1)
        poses_bounds[i, :15] = m.reshape(-1)
        poses_bounds[i, 15:] = [2.0 + rng.uniform(0, 0.2), 6.0 + rng.uniform(0, 0.5)]
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        path = os.path.join(basedir, "images", f"im{i:02d}.{ext}")
        if ext == "png":
            write_png(path, img)
        else:  # never decoded: the loader must refuse it by name
            with open(path, "wb") as fh:
                fh.write(b"\xff\xd8\xff\xe0 not decoded")
    np.save(os.path.join(basedir, "poses_bounds.npy"), poses_bounds)
    return basedir


@pytest.fixture(scope="module")
def llff_src(tmp_path_factory):
    return _write_llff(str(tmp_path_factory.mktemp("llff") / "scene"))


@pytest.mark.parametrize("factor,spherify,no_ndc,llffhold", [
    (1, False, False, 3), (1, True, True, 8), (2, False, True, 0), (2, True, False, 4)])
def test_llff_scene_matches_jax(tmp_path, llff_src, factor, spherify, no_ndc, llffhold):
    """Each package loads its own copy (``_minify`` caches images_2/ in the
    scene): equal poses, bounds and splits; the minified views within 1/255
    (both write 8-bit PNGs from the same Lanczos sums)."""
    ours_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(llff_src, ours_dir)
    shutil.copytree(llff_src, ref_dir)
    ours = load_llff_scene(ours_dir, factor, spherify, llffhold, no_ndc)
    ref = jload_llff_scene(ref_dir, factor, spherify, llffhold, no_ndc)
    _assert_scenes_equal(ours, ref, image_atol=1.0 / 255 + 1e-7)
    if factor == 1:
        np.testing.assert_array_equal(ours.images, ref.images)
    else:
        assert ours.images.shape == (6, 12, 16, 3)
        for name in sorted(os.listdir(os.path.join(ref_dir, "images_2"))):
            a = read_png(os.path.join(ours_dir, "images_2", name)).astype(int)
            b = read_png(os.path.join(ref_dir, "images_2", name)).astype(int)
            assert np.abs(a - b).max() <= 1, name


def test_llff_data_zflat_matches_jax(tmp_path, llff_src):
    shutil.copytree(llff_src, tmp_path / "s")
    got = load_llff_data(str(tmp_path / "s"), factor=1, path_zflat=True)
    want = jload_llff_data(str(tmp_path / "s"), factor=1, path_zflat=True)
    assert got[3].shape == (60, 3, 5) and got[4] == want[4]
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("factor", [1, 2])
def test_llff_jpeg_sources_raise_by_name(tmp_path, factor):
    """C.1: no imaging package, so a load or a minify that needs a JPEG from
    images/ raises, naming it, and writes no images_2/."""
    basedir = _write_llff(str(tmp_path / "s"), ext="JPG")
    with pytest.raises(ValueError, match=r"im00\.JPG.*PNG"):
        load_llff_scene(basedir, factor=factor)
    assert not os.path.exists(os.path.join(basedir, "images_2"))


def test_llff_prepared_png_images_load_beside_jpegs(tmp_path, llff_src):
    """C.1: a reference scene's images_{factor}/ (PNGs, as its mogrify
    writes them) loads as it is, with JPEGs in images/."""
    basedir = _write_llff(str(tmp_path / "s"), ext="JPG")
    shutil.copytree(os.path.join(llff_src, "images"), os.path.join(basedir, "images_2"))
    scene = load_llff_scene(basedir, factor=2, llffhold=3)
    want = np.stack([read_png(os.path.join(llff_src, "images", f)) for f in
                     sorted(os.listdir(os.path.join(llff_src, "images")))]) / 255.0
    np.testing.assert_array_equal(scene.images, want.astype(np.float32))
    assert scene.focal == 15.0  # hwf's focal / factor


# (d) the DeepVoxels and LINEMOD loaders


@pytest.fixture(scope="module")
def dv_dir(tmp_path_factory):
    """tests/test_config_and_data.py's layout, at 16x16 views (the loader
    takes H = W = 512 from the format, not from the views)."""
    root = tmp_path_factory.mktemp("dv")
    rng = np.random.default_rng(0)
    for split, n in [("train", 3), ("validation", 2), ("test", 5)]:
        base = root / split / "greek"
        os.makedirs(base / "pose")
        os.makedirs(base / "rgb")
        if split == "train":
            (base / "intrinsics.txt").write_text("280.0 256.0 250.0\n0 0 0\n0.8\n1.0\n512 512\n0\n")
        for i in range(n):
            pose = np.eye(4)
            pose[:3, 3] = rng.uniform(-1, 1, 3) + [0, 0, 2.5]
            (base / "pose" / f"{i:03d}.txt").write_text(" ".join(str(x) for x in pose.reshape(-1)))
            write_png(str(base / "rgb" / f"{i:03d}.png"),
                      rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    return str(root)


@pytest.mark.parametrize("testskip", [1, 2])
def test_deepvoxels_scene_matches_jax(dv_dir, testskip):
    _assert_scenes_equal(load_deepvoxels_scene(dv_dir, "greek", testskip),
                         jload_dv(dv_dir, "greek", testskip))


@pytest.fixture(scope="module")
def linemod_dir(tmp_path_factory):
    """RGBA views, per-frame K and json near/far (tests/test_config_and_data.py's
    layout); the test split's file paths absolute."""
    import json

    root = tmp_path_factory.mktemp("linemod")
    rng = np.random.default_rng(0)
    K = [[35.0, 0, 16], [0, 36.0, 15], [0, 0, 1]]
    for split, n in [("train", 3), ("val", 2), ("test", 3)]:
        frames = []
        os.makedirs(root / split)
        for i in range(n):
            path = root / split / f"r_{i}.png"
            write_png(str(path), rng.integers(0, 256, (32, 32, 4), dtype=np.uint8))
            pose = np.eye(4)
            pose[:3, 3] = rng.uniform(-1, 1, 3) + [0, 0, 4.0]
            frames.append({"file_path": str(path) if split == "test" else f"./{split}/r_{i}.png",
                           "transform_matrix": pose.tolist(), "intrinsic_matrix": K})
        meta = {"frames": frames, "near": 1.2 + 0.1 * n, "far": 6.3 + 0.2 * n}
        (root / f"transforms_{split}.json").write_text(json.dumps(meta))
    return str(root)


@pytest.mark.parametrize("half_res,testskip,white_bkgd", [
    (False, 1, False), (True, 2, True), (True, 1, False)])
def test_linemod_scene_matches_jax(linemod_dir, half_res, testskip, white_bkgd):
    ours = load_linemod_scene(linemod_dir, half_res, testskip, white_bkgd)
    _assert_scenes_equal(ours, jload_linemod(linemod_dir, half_res, testskip, white_bkgd))
    assert ours.K[0, 0] == 35.0 and (ours.near, ours.far) == (1.0, 7.0)  # floor / ceil


# (e) the procedural field and its ground truth


@pytest.mark.parametrize("backdrop", [False, True])
def test_make_field_and_scale_field_match_jax(backdrop):
    for ours, ref in ((synth.make_field(3, backdrop=backdrop), jsynth.make_field(3, backdrop=backdrop)),
                      (synth.scale_field(synth.make_field(7), 0.5),
                       jsynth.scale_field(jsynth.make_field(7), 0.5))):
        for f in ("centers", "inv_scales", "amps", "colors"):
            np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)


def _rays(R=64, seed=0):
    rng = np.random.default_rng(seed)
    ro = (np.array([0.0, 0.0, 4.0]) + rng.uniform(-0.3, 0.3, (R, 3))).astype(np.float32)
    rd = np.concatenate([rng.uniform(-0.35, 0.35, (R, 2)), -np.ones((R, 1))], -1)
    return ro, rd.astype(np.float32)


@pytest.mark.parametrize("backdrop", [False, True])
def test_field_and_gt_render_match_jax(backdrop):
    """64 rays x 32 samples. The port sums the primitives one at a time
    where XLA reduces a [..., K] axis, and its sin/exp are torch's: sigma
    within 1e-5 of max(|sigma|, 1) (relative, measured 1.4e-6), rgb and the
    render within 1e-5 absolute (measured 7e-7 and 1.5e-6; the depths are
    jnp.linspace's within an ulp)."""
    fp = synth.make_field(3, backdrop=backdrop)
    jfp = jsynth.make_field(3, backdrop=backdrop)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.2, 1.2, (64, 32, 3)).astype(np.float32)
    vd = rng.standard_normal((64, 32, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    sigma, rgb = synth.field_sigma_rgb(fp, torch.from_numpy(pts), torch.from_numpy(vd))
    jsigma, jrgb = (np.asarray(a) for a in jsynth.field_sigma_rgb(jfp, jnp.asarray(pts),
                                                                   jnp.asarray(vd)))
    assert jsigma.max() > 100 and (jsigma == 0).any()  # dense cores and empty space
    assert np.max(np.abs(sigma.numpy() - jsigma) / np.maximum(np.abs(jsigma), 1.0)) <= 1e-5
    np.testing.assert_allclose(rgb.numpy(), jrgb, rtol=0, atol=1e-5)

    ro, rd = _rays()
    got = synth.render_gt_rays(fp, torch.from_numpy(ro), torch.from_numpy(rd), 2.0, 6.0, 32)
    want = np.asarray(jsynth.render_gt_rays(jfp, jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0, 32))
    assert want.std() > 0.05
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_gt_image_does_not_depend_on_the_chunk():
    """An 8x10 frame (80 rays) in chunks of 16 and of 37 (the last padded):
    bit-equal, and within 1e-5 of nerf_tpu's jitted render."""
    fp, jfp = synth.make_field(0, backdrop=True), jsynth.make_field(0, backdrop=True)
    c2w = np.concatenate([np.eye(3), [[0.1], [-0.1], [4.0]]], 1)
    a = synth.render_gt_image(fp, 8, 10, 12.0, c2w, chunk=16, n_samples=64, device="cpu")
    b = synth.render_gt_image(fp, 8, 10, 12.0, c2w, chunk=37, n_samples=64, device="cpu")
    np.testing.assert_array_equal(a, b)
    want = jsynth.render_gt_image(jfp, 8, 10, 12.0, c2w, chunk=16, n_samples=64)
    np.testing.assert_allclose(a, want, rtol=0, atol=1e-5)


# (f) the four scene writers, read back through load_scene


def _gt_u8(fp, H, W, focal, c2w, **kw):
    return (np.clip(synth.render_gt_image(fp, H, W, focal, c2w, device="cpu", **kw), 0, 1)
            * 255).astype(np.uint8)


def _write_and_load(kind, out):
    """(scene, [(view index, expected 8-bit view)]) for one writer's scene."""
    if kind == "blender":
        written = make_benchmark_scene.write_scene(out, {"train": 2, "val": 1, "test": 1},
                                                   res=16, device="cpu")
        cfg = dict(dataset_type="blender", white_bkgd=True, testskip=1)
        focal = 0.5 * 16 / np.tan(0.5 * make_benchmark_scene.CAMERA_ANGLE_X)
        want = [(3, _gt_u8(synth.make_field(0), 16, 16, focal, written["test"][0]))]
    elif kind == "llff":
        c2w = make_llff_benchmark_scene.write_scene(out, n_views=3, hw=(12, 16), device="cpu")
        cfg = dict(dataset_type="llff", factor=1, llffhold=8)
        focal = make_llff_benchmark_scene.FOCAL * 16 / make_llff_benchmark_scene.W
        want = [(1, _gt_u8(synth.make_field(0, backdrop=True), 12, 16, focal, c2w[1]))]
    elif kind == "deepvoxels":
        written = make_deepvoxels_scene.write_scene(
            out, {"train": 2, "validation": 1, "test": 1}, res=16, device="cpu")
        cfg = dict(dataset_type="deepvoxels", shape="greek_synth", testskip=1)
        fp = synth.scale_field(synth.make_field(7), 0.5)
        want = [(2, _gt_u8(fp, 16, 16, make_deepvoxels_scene.FOCAL / 32,
                           written["validation"][0], near=1.0, far=3.0))]
    else:
        written = make_linemod_scene.write_scene(out, {"train": 2, "val": 1, "test": 1},
                                                 res=16, device="cpu")
        cfg = dict(dataset_type="LINEMOD", white_bkgd=True, testskip=1)
        want = [(0, _gt_u8(synth.make_field(11), 16, 16, make_linemod_scene.FOCAL / 25,
                           written["train"][0]))]
    scene = load_scene(tconfig.NeRFConfig(datadir=out, **cfg))
    return scene, want


@pytest.mark.parametrize("kind", ["blender", "llff", "deepvoxels", "LINEMOD"])
def test_scene_writer_reads_back(tmp_path, kind):
    """Each writer's scene loads through load_scene, and a view is the
    port's render_gt_image of its pose, truncated to 8 bits, exactly."""
    scene, want = _write_and_load(kind, str(tmp_path / kind))
    for i, img in want:
        np.testing.assert_array_equal(scene.images[i], (img / 255.0).astype(np.float32))
    if kind == "llff":
        assert (scene.near, scene.far) == (0.0, 1.0) and list(scene.i_test) == [0]
    elif kind == "deepvoxels":
        assert abs(scene.near - 1.0) < 1e-5 and abs(scene.far - 3.0) < 1e-5  # radius 2
    elif kind == "LINEMOD":
        assert (scene.near, scene.far) == (2.0, 6.0) and scene.K[0, 0] == np.float32(520.0 / 25)


# (g) the Keras weight import


def test_keras_import_matches_nerf_tpu():
    """Seeded Keras-layout weights at width 32: both packages' pytrees are
    equal, and the port's MLP loaded through models/convert.py gives
    nerf_tpu's outputs (f32, 1e-5)."""
    D, W = 8, 32
    rng = np.random.default_rng(0)
    dims = [(63, W)] + [(W, W)] * (D - 1)
    dims[5] = (W + 63, W)  # after the skip at layer 4
    dims += [(W, W), (W + 27, W // 2), (W // 2, 3), (W, 1)]  # feature, views, rgb, alpha
    weights = []
    for fan_in, fan_out in dims:
        weights += [rng.standard_normal((fan_in, fan_out)).astype(np.float32) * 0.2,
                    rng.standard_normal((fan_out,)).astype(np.float32) * 0.05]
    cfg, jcfg = MLPConfig(width=W), JMLPConfig(width=W)
    ours, ref = params_from_keras(weights, cfg), jparams_from_keras(weights, jcfg)
    leaves = lambda p: [p["trunk"][i][k] for i in range(D) for k in "wb"] + [
        p[h][k] for h in ("feature", "views", "rgb", "alpha") for k in "wb"]
    for a, b in zip(leaves(ours), leaves(ref)):
        np.testing.assert_array_equal(a, b)

    net = NeRFMLP(cfg, device="cpu")
    net.load_state_dict(state_dict_from_jax_params(ours, cfg), strict=True)
    x = rng.standard_normal((64, 63)).astype(np.float32)
    v = rng.standard_normal((64, 27)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    want = np.asarray(japply_mlp(ref, jcfg, jnp.asarray(x), jnp.asarray(v)))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="use_viewdirs"):
        params_from_keras(weights, MLPConfig(width=W, use_viewdirs=False))


# (h) train() on an LLFF scene: NDC rays and the batching sampler


def test_train_llff_ndc_batching_on_cpu(tmp_path, llff_src):
    """configs/synthff.txt's recipe (NDC, use_batching, raw_noise_std 1,
    64+64) at a 32-wide MLP and 8+8 samples, 2 steps on the CPU: the scene
    dispatches to the LLFF loader and the loss is finite."""
    shutil.copytree(llff_src, tmp_path / "scene")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flags = {"config": os.path.join(repo, "configs", "synthff.txt"),
             "datadir": str(tmp_path / "scene"), "basedir": str(tmp_path / "logs"),
             "netwidth": 32, "netwidth_fine": 32, "N_samples": 8, "N_importance": 8,
             "N_rand": 64, "n_iters": 2, "i_print": 1, "i_img": 0, "i_weights": 0,
             "i_testset": 0, "i_video": 0, "fused_kernels": False, "data_axis": 1}
    cfg = tconfig.load_config([f"--{k}={v}" for k, v in flags.items()])
    assert cfg.ndc and not cfg.no_batching and cfg.raw_noise_std == 1.0 and cfg.factor == 2
    result = train(cfg, device="cpu")
    assert os.path.isdir(tmp_path / "scene" / "images_2")
    assert [h[0] for h in result.history] == [1, 2]
    assert all(np.isfinite(h[1]) for h in result.history)
