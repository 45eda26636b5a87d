"""The port's data parallelism against one process and nerf_tpu, on the CPU.

One module-scoped fixture starts two gloo ranks once
(``parallel.distributed.launch``); each runs
tests/torch_port_parallel_worker.py: ``cli.train.main`` with
``--data_axis 2`` for 6 steps with every cadence firing (the fused loop,
its chunks capped at 2 by i_print), the same ranks step by step, and a
batching run fused and step by step, then nerf_tpu's shard_map step as the
port runs it (with the schedule's float and with an ``lr`` tensor), both
samplers and the mesh-sharded frame renderer, then
``cli.train_multi.main`` on two scenes with ``--data_axis 2`` (a scene a
rank), and sends back its state and outputs.
The same ``cli.train.main`` and ``cli.train_multi.main`` run once more in
this process with ``--data_axis 1``. A second module fixture starts four
gloo ranks, a data 2 × model 2 mesh, for the DP×TP step (ROADMAP A.8b):
held against nerf_tpu's ``shard_model_axis=True`` step without draws and
against the port's one-process step with them, its mesh-sharded frame,
and the model-parallel MLP's gradients against the whole MLP's.
At the smallest shapes that catch a wrong result: a 16x16 blender scene,
4x64 nets, N_rand 64, 8+8 samples. The card's run of the same path is
chip_smoke.py's phase 24.
"""

import contextlib
import dataclasses
import io
import os
import pickle
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from nerf_tpu.models import factory as jfactory
from nerf_tpu.models.nerf_mlp import MLPConfig as JMLPConfig
from nerf_tpu.models.nerf_mlp import init_params as jinit_params
from nerf_tpu.parallel import mesh as jmesh
from nerf_tpu.train import loop as jloop
from nerf_tpu.train import step as jstep
from nerf_tpu_torch import config as tconfig
from nerf_tpu_torch.cli import train as cli_train
from nerf_tpu_torch.cli import train_multi
from nerf_tpu_torch.data import rays_dataset
from nerf_tpu_torch.data.blender import load_blender_scene
from nerf_tpu_torch.geom.poses import pose_spherical
from nerf_tpu_torch.models import factory as tfactory
from nerf_tpu_torch.models.convert import jax_params_from_state_dict, state_dict_from_jax_params
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.parallel import distributed
from nerf_tpu_torch.parallel.mesh import (
    Mesh, make_sharded_train_step, param_sharding, shard_state,
)
from nerf_tpu_torch.parallel.multi_scene import scene_seed
from nerf_tpu_torch.render.network import NeRFModel
from nerf_tpu_torch.render.renderer import RenderSettings, make_frame_renderer
from nerf_tpu_torch.train import loop as tloop
from nerf_tpu_torch.train.step import init_train_state, make_train_step
from nerf_tpu_torch.utils import checkpoint
from nerf_tpu_torch.utils.io import read_png

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synthetic_scene import write_blender_dataset  # noqa: E402
from torch_port_parallel_worker import rank_run, tp_rank, train_rank  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
STEPS = 6
CADENCES = {"i_print": 2, "i_img": 3, "i_weights": 6, "i_testset": 6, "i_video": 6}
LRATE = 5e-4
# Adam moves a weight by about lr per step whatever the size of its grad, so
# two runs whose grads differ in the last bits (here: f32 sums in another
# order, or nerf_tpu's ops against the port's) move a weight by up to a few
# lr: tests/test_torch_port_train.py::test_train_steps_match_jax's bounds
UPDATE_TOL = 5e-2
# the samplers' batches: 3 train views of 16x16 are 768 rays, 19.2 batches
# of 40, so the 20th batch wraps with 8 rays of the old epoch
SAMPLER_RAND, SAMPLER_BATCHES = 40, 21
FRAME_HW = (15, 15)  # an odd number of rays: the sharded renderer pads
FRAME_TOL = 1e-6


def _argv(tmp, datadir, expname, data_axis, **override):
    flags = {"config": str(REPO / "configs" / "lego.txt"), "datadir": datadir,
             "basedir": str(tmp / "logs"), "expname": expname, "half_res": False,
             "testskip": 1, "netdepth": 4, "netwidth": 64, "netdepth_fine": 4,
             "netwidth_fine": 64, "N_samples": 8, "N_importance": 8, "N_rand": 64,
             "precrop_iters": 2, "compute_dtype": "float32", "n_iters": STEPS,
             "data_axis": data_axis, **CADENCES, **override}
    return [f"--{k}={v}" for k, v in flags.items()]


NO_EVENTS = {"i_img": 0, "i_weights": 0, "i_testset": 0, "i_video": 0}
# the batching policy's fused run: chunks of 4 (steps 1-4, ..., 17-20); its
# 40-ray batches wrap the 768 rays' epoch at step 20, inside the last chunk
BATCHING = {"no_batching": False, "N_rand": 40, "n_iters": 20, "i_print": 4, **NO_EVENTS}
BATCHING_CHUNKS = 5


def _fuse_argvs(tmp, datadir):
    """(fused, per-step) argv of each policy's ranks; the image policy's
    fused run is the ranks' main run (None). A per-step run drops the eval
    cadences, which change no state, and keeps i_print's history."""
    return {"image": (None, _argv(tmp, datadir, "dp1", 2, fuse_steps=1, **NO_EVENTS)),
            "batching": (_argv(tmp, datadir, "dpb", 2, fuse_steps=4, **BATCHING),
                         _argv(tmp, datadir, "dpb1", 2, fuse_steps=1, **BATCHING))}


MULTI_STEPS = 4


def _multi_argv(tmp, datadir, data_axis):
    """cli.train_multi on two scenes of the one dataset (their own seeds),
    8x128 nets (the stacked K1/K4's family), i_print 2 and i_weights 4."""
    paths = []
    for s in range(2):
        cfg = tmp / f"multi{s}_{data_axis}.txt"
        cfg.write_text(f"expname = multi{s}_{data_axis}\nbasedir = {tmp / 'logs'}\n"
                       f"datadir = {datadir}\ndataset_type = blender\nno_batching = True\n"
                       "use_viewdirs = True\nwhite_bkgd = True\nN_rand = 32\nN_samples = 8\n"
                       "N_importance = 8\nnetwidth = 128\nnetwidth_fine = 128\n"
                       "half_res = False\ntestskip = 1\ncompute_dtype = float32\n"
                       "precrop_iters = 2\n")
        paths.append(str(cfg))
    return ["--configs", *paths, "--n_iters", str(MULTI_STEPS), "--i_print", "2",
            "--i_weights", str(MULTI_STEPS), "--data_axis", str(data_axis)]


def _step_job(cfg, n_steps=2):
    """``n_steps`` train steps' inputs for (c): initial weights (the port's,
    seeded, and as nerf_tpu's pytree), rays, targets and the whole batch's
    draws."""
    tmodel = tfactory.make_model(cfg)
    nets = tfactory.init_nets(tmodel, 3, "cpu")
    sds = {lvl: {n: p.detach().clone() for n, p in net.state_dict().items()}
           for lvl, net in nets.items()}
    params = {lvl: jax_params_from_state_dict(sd, getattr(tmodel, lvl)) for lvl, sd in sds.items()}
    rng = np.random.default_rng(7)
    n = cfg.N_rand
    batches = []
    for _ in range(n_steps):
        ro = rng.normal(0, 0.3, (n, 3)).astype(np.float32) + np.float32([0, 0, 4])
        rd = rng.normal(0, 0.2, (n, 3)).astype(np.float32) + np.float32([0, 0, -1])
        batch = (ro, rd, np.full(n, 2.0, np.float32), np.full(n, 6.0, np.float32),
                 rng.uniform(0, 1, (n, 3)).astype(np.float32))
        overrides = {"t_rand": rng.uniform(size=(n, cfg.N_samples)).astype(np.float32),
                     "u": rng.uniform(size=(n, cfg.N_importance)).astype(np.float32)}
        batches.append((batch, overrides))
    return params, {"params": sds, "batches": batches}


@contextlib.contextmanager
def _stdout_to(path):
    """fd 1 (this process's and the ranks' it starts) into ``path``."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    datadir = str(tmp / "blender")
    write_blender_dataset(datadir, n_train=3, n_val=2, n_test=3, H=16, W=16)
    one_argv = _argv(tmp, datadir, "one", 1)
    cfg = tconfig.load_config(one_argv)
    jparams, step_job = _step_job(cfg)
    job = {"argv": _argv(tmp, datadir, "dp", 2), "cfg": cfg, "step": step_job,
           "scene": (datadir, False, 1, True), "sampler": (SAMPLER_RAND, SAMPLER_BATCHES),
           "frame_hw": FRAME_HW, "chunk": 50, "multi_argv": _multi_argv(tmp, datadir, 2),
           "fuse_argvs": _fuse_argvs(tmp, datadir)}
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the ranks' torch: one thread, as here
    torch.set_num_threads(1)
    try:
        with _stdout_to(tmp / "dp.log"):
            ranks = distributed.launch(rank_run, 2, "cpu", args=(job,))
        with _stdout_to(tmp / "one.log"):
            one = cli_train.main(one_argv, device="cpu")
            multi_argv = _multi_argv(tmp, datadir, 1)
            multi = train_multi.main(multi_argv, device="cpu")
        yield {"tmp": tmp, "cfg": cfg, "ranks": ranks, "one": one, "jparams": jparams,
               "multi": multi, "multi_cfg": train_multi.load_configs(multi_argv)[0],
               "step_job": step_job, "dp_log": (tmp / "dp.log").read_text(),
               "one_log": (tmp / "one.log").read_text()}
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp


def _pairs(a, b):
    for level in a:
        for name in a[level]:
            yield f"{level}.{name}", a[level][name], b[level][name]


def _assert_close_to(got, want, start):
    """Two trainings from ``start``: each weight within 4 lr, and each
    leaf's update within UPDATE_TOL relative L2."""
    for level in got:
        for name, g in got[level].items():
            w, p0 = want[level][name], start[level][name]
            assert float((g - w).abs().max()) <= 4 * LRATE, (level, name)
            moved = torch.linalg.norm(w - p0)
            if moved > 0:
                assert float(torch.linalg.norm(g - w) / moved) <= UPDATE_TOL, (level, name)


# (a) the replicas stay equal


def test_ranks_hold_equal_params_and_moments(runs):
    r0, r1 = (r["state"] for r in runs["ranks"])
    assert r0["step"] == r1["step"] == STEPS
    for key in ("params", "moments"):
        for name, a, b in _pairs(r0[key], r1[key]):
            if key == "params":
                assert torch.equal(a, b), name
            else:
                assert all(torch.equal(x, y) for x, y in zip(a, b)), name
    assert set(r0["moments"]["fine"]) == set(r0["params"]["fine"])


# (b) two ranks train as one process does


def test_two_ranks_match_one_process(runs):
    one = runs["one"]
    hist = [r["history"] for r in runs["ranks"]]
    assert hist[0] == hist[1]
    assert [h[0] for h in hist[0]] == [h[0] for h in one.history] == [2, 4, 6]
    for (_, loss, _), (_, want, _) in zip(hist[0], one.history):
        np.testing.assert_allclose(loss, want, rtol=1e-5)
    start = tfactory.init_nets(tfactory.make_model(runs["cfg"]), runs["cfg"].seed, "cpu")
    start = {lvl: {n: p.detach() for n, p in net.named_parameters()} for lvl, net in start.items()}
    want = {lvl: {n: p.detach() for n, p in net.named_parameters()}
            for lvl, net in one.state.nets.items()}
    _assert_close_to(runs["ranks"][0]["state"]["params"], want, start)
    assert "[MESH] data-parallel over 2 ranks" in runs["dp_log"]
    assert runs["dp_log"].count("[TRAIN] Iter: 2 ") == 1  # rank 0 prints


# (b2) the fused loop over ranks is the same ranks step by step


def _assert_states_equal(a, b, what):
    assert a["step"] == b["step"], what
    for key in ("params", "moments"):
        assert set(a[key]) == set(b[key]), what
        for name, x, y in _pairs(a[key], b[key]):
            if key == "params":
                assert torch.equal(x, y), (what, name)
            else:
                assert all(torch.equal(u, v) for u, v in zip(x, y)), (what, key, name)


@pytest.mark.parametrize("policy,chunks,prints", [("image", 1, [2, 4, 6]),
                                                  ("batching", BATCHING_CHUNKS, [4, 8, 12, 16, 20])])
def test_fused_ranks_equal_per_step_ranks(runs, policy, chunks, prints):
    """``--fuse_steps=1`` on the same two ranks: history, parameters and
    Adam's moments ``torch.equal`` the fused run's, on every rank. On the
    CPU a chunk runs its k steps eagerly (the graph's plain version), with
    the samplers' rank rows and the sharded step's lr from the device table."""
    for r, rank in enumerate(runs["ranks"]):
        fused, per_step = rank["fuse"][policy]
        assert (fused["chunks"], per_step["chunks"]) == (chunks, 0), (policy, r)
        assert [h[0] for h in fused["history"]] == prints, (policy, r)
        assert fused["history"] == per_step["history"], (policy, r)
        assert fused["state"]["step"] == prints[-1]
        _assert_states_equal(fused["state"], per_step["state"], (policy, r))
    assert "[FUSE] fuse_steps=50 capped to 2" in runs["dp_log"]


def test_sharded_step_takes_an_lr_tensor(runs):
    """The sharded step with a float32 tensor of the schedule's rate (the
    fused loop's table) makes the updates the schedule's float makes."""
    for rank in runs["ranks"]:
        assert rank["step_lr_tensor"]["losses"] == rank["step"]["losses"]
        _assert_states_equal(rank["step_lr_tensor"]["state"], rank["step"]["state"], "lr")
        # and the tensor is the rate the step uses
        doubled = rank["step_lr_double"]["state"]["params"]
        assert not all(torch.equal(a, b) for _, a, b in _pairs(doubled,
                                                               rank["step"]["state"]["params"]))


def test_one_rank_group_trains_as_one_process(tmp_path):
    """A group of one rank trains over its mesh (the all-reduces over
    itself: chip_smoke.py's one-card check of the fused loop over ranks),
    fused, and makes one process's updates bit for bit."""
    datadir = str(tmp_path / "blender")
    write_blender_dataset(datadir, n_train=3, n_val=1, n_test=1, H=16, W=16)
    argv = _argv(tmp_path, datadir, "mesh1", 1, fuse_steps=4, **BATCHING)
    (rank,) = distributed.launch(train_rank, 1, "cpu", args=(argv,))
    with contextlib.redirect_stdout(io.StringIO()) as log:
        one = cli_train.main(_argv(tmp_path, datadir, "one1", 1, fuse_steps=4, **BATCHING),
                             device="cpu")
    assert "[MESH] data-parallel over 1 ranks" in rank["log"] and "[MESH]" not in log.getvalue()
    assert rank["chunks"] == one.chunks == BATCHING_CHUNKS
    assert rank["history"] == one.history
    one_state = {"step": one.state.step,
                 "params": {lvl: dict(net.named_parameters()) for lvl, net in one.state.nets.items()},
                 "moments": {lvl: {n: tuple(one.state.optimizer.state[p][k]
                                            for k in ("exp_avg", "exp_avg_sq"))
                                   for n, p in net.named_parameters()}
                             for lvl, net in one.state.nets.items()}}
    _assert_states_equal(rank["state"], one_state, "one rank")


def test_fuse_refusal_names_the_groups_that_step_one_by_one():
    """Which loops fuse: one process anywhere, ranks on the CPU and NCCL
    ranks on cards; gloo ranks on a card print the line and step by step."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert tloop.fuse_refusal(50, 1, cuda, None) is None
    assert tloop.fuse_refusal(50, 1, cpu, None) is None
    assert tloop.fuse_refusal(50, 2, cpu, "gloo") is None
    assert tloop.fuse_refusal(50, 4, cuda, "nccl") is None
    assert tloop.fuse_refusal(4, 2, cuda, "gloo") == (
        "[FUSE] fuse_steps=4 not fused over 2 gloo ranks on cards: gloo's all-reduce of a "
        "card's tensor goes through the host, which a CUDA graph cannot hold; step by step")
    assert distributed.capturable("nccl") and not distributed.capturable("gloo")


# (c) the port's 2-rank step against nerf_tpu's shard_map step


def test_two_rank_step_matches_shard_map(runs):
    cfg = runs["cfg"]
    jmodel = jfactory.make_model(cfg)
    rs = jloop.render_settings_from_config(cfg)
    core = jstep.make_train_step_core(jmodel, rs, cfg.lrate, cfg.lrate_decay, axis_name="data")
    mesh = JMesh(np.asarray(jax.devices()[:2]), ("data",))
    mapped = jax.jit(jax.shard_map(core, mesh=mesh, in_specs=(P(),) + (P("data"),) * 6,
                                   out_specs=(P(), P()), check_vma=False))
    state = jstep.init_train_state(runs["jparams"], cfg.lrate, cfg.lrate_decay)
    losses = []
    for batch, overrides in runs["step_job"]["batches"]:
        state, aux = mapped(state, *(jnp.asarray(a) for a in batch),
                            {k: jnp.asarray(v) for k, v in overrides.items()})
        losses.append(float(aux["loss"]))
    got = runs["ranks"][0]["step"]
    assert got["losses"] == runs["ranks"][1]["step"]["losses"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    tmodel = tfactory.make_model(cfg)
    want = {lvl: {n: torch.from_numpy(np.asarray(v)) for n, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, state.params[lvl]), getattr(tmodel, lvl)).items()}
        for lvl in ("coarse", "fine")}
    _assert_close_to(got["state"]["params"], want, runs["step_job"]["params"])


# (d) the samplers' rank rows are the one-process batch


def test_sampler_rank_rows_make_the_batch(runs):
    cfg = runs["cfg"]
    scene = load_blender_scene(*(str(runs["tmp"] / "blender"), False, 1, True))
    batched = rays_dataset.BatchedRaySampler(scene, SAMPLER_RAND, torch.Generator().manual_seed(5),
                                             device="cpu")
    image = rays_dataset.ImageRaySampler(scene, SAMPLER_RAND, torch.Generator().manual_seed(6),
                                         precrop_iters=2, device="cpu")
    want = {"batched": [batched.next_batch() for _ in range(SAMPLER_BATCHES)],
            "image": [image.next_batch(i) for i in range(1, 5)]}
    assert batched.perm.shape[0] == batched.n_total + 8  # the wrap kept the old tail
    for kind, batches in want.items():
        for k, batch in enumerate(batches):
            for j, whole in enumerate(batch):
                rows = [r[kind][k][j] for r in runs["ranks"]]
                assert rows[0].shape[0] == SAMPLER_RAND // 2
                assert torch.equal(torch.cat(rows), whole), (kind, k, j)


# (e) the shared test-set render is render_path's


def test_render_path_multiprocess_matches_render_path(runs, tmp_path, capsys):
    cfg = runs["cfg"]
    state = runs["ranks"][0]["state"]
    model = tfactory.make_model(cfg)
    nets = tfactory.init_nets(model, 0, "cpu")
    for lvl, net in nets.items():
        net.load_state_dict(state["params"][lvl])
    scene = tloop.load_scene(cfg)
    rs = tloop.render_settings_from_config(cfg)
    tloop.render_path(nets, model, rs, scene, scene.poses[scene.i_test], cfg.chunk,
                      savedir=str(tmp_path), gt_imgs=scene.images[scene.i_test], device="cpu")
    want = re.findall(r"mean PSNR over 3 views: (\S+)", capsys.readouterr().out)
    got = re.findall(r"mean PSNR over 3 views \(2 processes\): (\S+)", runs["dp_log"])
    assert got == want and len(want) == 1
    shared = runs["tmp"] / "logs" / "dp" / f"testset_{STEPS:06d}"
    assert sorted(os.listdir(shared)) == sorted(os.listdir(tmp_path)) == \
        ["000.png", "001.png", "002.png"]
    for f in os.listdir(tmp_path):
        np.testing.assert_array_equal(read_png(str(shared / f)), read_png(str(tmp_path / f)))
    expdir = runs["tmp"] / "logs" / "dp"
    assert not [f for f in os.listdir(expdir) if f.startswith(".")]  # stages cleared
    spiral = [f for f in os.listdir(expdir) if f.startswith(f"dp_spiral_{STEPS:06d}_rgb")]
    assert len(spiral) == 1


# (f) the mesh-sharded frame renderer is the unsharded one


def test_sharded_frame_renderer_matches_unsharded(runs):
    cfg = runs["cfg"]
    model = tfactory.make_model(cfg)
    nets = tfactory.init_nets(model, 0, "cpu")
    for lvl, net in nets.items():
        net.load_state_dict(runs["ranks"][0]["state"]["params"][lvl])
    scene = load_blender_scene(str(runs["tmp"] / "blender"), False, 1, True)
    rs = tloop.render_settings_from_config(cfg).eval_mode()
    H, W = FRAME_HW
    want = make_frame_renderer(model, rs, H, W, scene.K, scene.near, scene.far,
                               device="cpu")(nets, scene.poses[0])
    f0, f1 = (r["frame"] for r in runs["ranks"])
    assert set(f0) == set(want) and "rgb0" in want
    for k in want:
        assert f0[k].shape == want[k].shape == (H, W, *want[k].shape[2:]), k
        assert torch.equal(f0[k], f1[k]), k
        torch.testing.assert_close(f0[k], want[k], rtol=0, atol=FRAME_TOL, equal_nan=True)
    mesh = Mesh(group=None, size=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="deterministic"):
        make_frame_renderer(model, tloop.render_settings_from_config(cfg), H, W, scene.K,
                            scene.near, scene.far, device="cpu", mesh=mesh)


# (g) the .tar written under two ranks resumes in one process


def test_two_rank_tar_resumes_in_one_process(runs, tmp_path):
    cfg = runs["cfg"]
    expdir = runs["tmp"] / "logs" / "dp"
    assert sorted(f for f in os.listdir(expdir) if f.endswith(".tar")) == [f"{STEPS:06d}.tar"]
    model = tfactory.make_model(cfg)
    loaded = checkpoint.load_checkpoint(str(expdir / f"{STEPS:06d}.tar"), model, cfg.lrate, "cpu")
    r0 = runs["ranks"][0]["state"]
    assert loaded.step == STEPS
    for lvl, net in loaded.nets.items():
        for name, p in net.named_parameters():
            assert torch.equal(p, r0["params"][lvl][name]), name
            st = loaded.optimizer.state[p]
            assert torch.equal(st["exp_avg"], r0["moments"][lvl][name][0]), name
            assert torch.equal(st["exp_avg_sq"], r0["moments"][lvl][name][1]), name
    resumed = tloop.train(dataclasses.replace(
        cfg, basedir=str(expdir.parent), expname="dp", n_iters=STEPS + 1, i_img=0, i_weights=0,
        i_testset=0, i_video=0, datadir=str(runs["tmp"] / "blender")), device="cpu")
    assert resumed.state.step == STEPS + 1


# (h) multi-scene training with the scene axis over the ranks


def test_two_ranks_train_their_scenes_as_one_process(runs):
    """``cli.train_multi --data_axis 2``: rank r trains scene r alone (no
    collective), and each scene's losses and weights are the one-process
    stacked run's, within this file's bounds for sums in another order
    (tests/test_torch_port_multi.py's stacked-step comparison); a .tar a
    scene, written by the rank that owns it."""
    one = runs["multi"]
    assert one.scenes == [0, 1]
    model = tfactory.make_model(runs["multi_cfg"])
    for r, rank in enumerate(runs["ranks"]):
        got = rank["multi"]
        assert got["scenes"] == [r]
        assert [h[0] for h in got["history"]] == [h[0] for h in one.history] == [2, 4]
        for (_, loss, _), (_, want, _) in zip(got["history"], one.history):
            np.testing.assert_allclose(loss[0], want[r], rtol=1e-5)
        start = tfactory.init_nets(model, scene_seed(runs["multi_cfg"].seed, r), "cpu")
        start = {lvl: {n: p.detach() for n, p in net.named_parameters()}
                 for lvl, net in start.items()}
        want = {lvl: net.scene_state_dict(r) for lvl, net in one.state.nets.items()}
        params = {lvl: {n: p[0] for n, p in ps.items()} for lvl, ps in got["state"]["params"].items()}
        _assert_close_to(params, want, start)
        tar = runs["tmp"] / "logs" / f"multi{r}_2" / f"{MULTI_STEPS:06d}.tar"
        assert tar.exists()


# the CLI's launcher, without starting processes


def test_cli_launches_the_ranks_data_axis_asks_for(monkeypatch, tmp_path):
    cfg = tconfig.NeRFConfig(basedir=str(tmp_path), data_axis=2, dataset_type="blender")
    calls = []
    monkeypatch.setattr(distributed, "launch",
                        lambda fn, n, device, args=(): calls.append((fn, n, device, args)))
    cli_train.run(cfg, device="cpu")
    (fn, n, device, args), = calls
    assert (n, device, args) == (2, "cpu", (cfg,)) and fn is cli_train._train_rank
    pickle.dumps((fn, args))  # spawn sends both to every rank
    assert cli_train.data_ranks(dataclasses.replace(cfg, data_axis=0), "cpu") == 1
    assert cli_train.data_ranks(dataclasses.replace(cfg, data_axis=3), "cpu") == 3
    with pytest.raises(ValueError, match="2 ranks"):
        distributed.shard_slice(63, 0, 2)
    assert distributed.host_shard_slice(64) == slice(0, 64)  # no group: all rows


# (i) the DP×TP step (ROADMAP A.8b): four gloo ranks, data 2 × model 2


TP_STEPS = 3
TP_SEED = 11  # the draws' generator, on every rank and in the one process
TP_NOISE = 1.0
GRAD_TOL = 1e-5  # the model-parallel MLP's gathered grads against the whole MLP's


def _tp_model(cfg):
    """The port's model of ``cfg`` with the kernels off: the DP×TP step runs
    the plain MLP."""
    return dataclasses.replace(tfactory.make_model(cfg), fused=False, fused_render=False)


def _grad_check_job():
    """Inputs of the model-parallel MLP's gradient check: 8×64 nets with and
    without viewdirs (output_linear's 4 columns split at n_model 2), 50
    embedded points, their embedded directions and a cotangent of raw."""
    rng = np.random.default_rng(9)
    job = {}
    for name, views in (("viewdirs", True), ("no_viewdirs", False)):
        cfg = MLPConfig(width=64, use_viewdirs=views)
        x = rng.normal(0, 1, (50, cfg.input_ch)).astype(np.float32)
        v = rng.normal(0, 1, (50, cfg.input_ch_views)).astype(np.float32) if views else None
        cot = rng.normal(0, 1, (50, 4)).astype(np.float32)
        job[name] = (cfg, x, v, cot)
    return job


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    cfg = tconfig.load_config(_argv(tmp, str(tmp / "blender"), "tp", 1))
    jparams, step_job = _step_job(cfg, TP_STEPS)
    rs = tloop.render_settings_from_config(cfg)
    batches = [batch for batch, _ in step_job["batches"]]
    job = {"model": _tp_model(cfg), "params": step_job["params"], "lrate": cfg.lrate,
           "lrate_decay": cfg.lrate_decay,
           "runs": {"det": (dataclasses.replace(rs, perturb=False, raw_noise_std=0.0), None,
                            batches),
                    "drawn": (dataclasses.replace(rs, perturb=True, raw_noise_std=TP_NOISE),
                              TP_SEED, batches)},
           "grad_check": _grad_check_job(), "frame": (*FRAME_HW, _frame_K(), _frame_pose())}
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    try:
        ranks = distributed.launch(tp_rank, 4, "cpu", args=(job,))
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp
    return {"cfg": cfg, "jparams": jparams, "job": job, "ranks": ranks,
            "start": step_job["params"]}


def _frame_K():
    f = 14.0
    return np.array([[f, 0, FRAME_HW[1] / 2], [0, f, FRAME_HW[0] / 2], [0, 0, 1]], np.float32)


def _frame_pose():
    return np.asarray(pose_spherical(30.0, -30.0, 4.0), np.float32)


def _assert_moments_close(got, want):
    """Each Adam moment within UPDATE_TOL relative L2 of the reference's:
    ``_assert_close_to``'s bound on an update, from zeros."""
    for level in want:
        for name, pair in want[level].items():
            for g, w in zip(got[level][name], pair):
                moved = torch.linalg.norm(w)
                if moved > 0:
                    assert float(torch.linalg.norm(g - w) / moved) <= UPDATE_TOL, (level, name)


def _assert_ranks_agree(tp, key):
    """Every rank's gathered state is the same whole state, and its losses
    the same."""
    r0 = tp["ranks"][0][key]
    for rank in tp["ranks"][1:]:
        assert rank[key]["losses"] == r0["losses"]
        _assert_states_equal(rank[key]["state"], r0["state"], key)
    return r0


def test_tp_mesh_places_ranks_and_rows(tp):
    """Rank r sits at (r // 2, r % 2), and holds half the rows of each
    sharded layer: the trunk, feature_linear, views_linears.0; alpha_linear
    and rgb_linear whole."""
    for r, rank in enumerate(tp["ranks"]):
        assert (rank["rank"], rank["data_index"], rank["model_index"]) == (r, r // 2, r % 2)
        rows = rank["det"]["rows"]["fine"]
        assert rows["pts_linears.0.weight"] == (32, 63)
        assert rows["pts_linears.3.weight"] == (32, 64)
        assert rows["feature_linear.bias"] == (32,)
        assert rows["views_linears.0.weight"] == (16, 64 + 27)
        assert rows["alpha_linear.weight"] == (1, 64)
        assert rows["rgb_linear.weight"] == (3, 32)


def test_tp_step_matches_nerf_tpu(tp):
    """Three steps without draws against nerf_tpu's DP×TP step
    (``make_sharded_train_step(make_mesh(2, 2), shard_model_axis=True)``)
    on the same weights and batches: losses, parameters and Adam's moments."""
    cfg = tp["cfg"]
    jmodel = dataclasses.replace(jfactory.make_model(cfg), fused=False, fused_render=False)
    rs = dataclasses.replace(jloop.render_settings_from_config(cfg), perturb=False,
                             raw_noise_std=0.0)
    mesh = jmesh.make_mesh(2, 2, jax.devices()[:4])
    state = jstep.init_train_state(tp["jparams"], cfg.lrate, cfg.lrate_decay)
    step = jmesh.make_sharded_train_step(mesh, jmodel, rs, cfg.lrate, cfg.lrate_decay,
                                         donate=False, shard_model_axis=True)(state)
    losses = []
    for batch in tp["job"]["runs"]["det"][2]:
        state, aux = step(state, *jmesh.shard_batch(mesh, *(jnp.asarray(a) for a in batch)),
                          jax.random.key(0))
        losses.append(float(aux["loss"]))
    got = _assert_ranks_agree(tp, "det")
    assert got["state"]["step"] == TP_STEPS
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    tmodel = tp["job"]["model"]

    def named(tree):
        return {lvl: {n: torch.from_numpy(np.asarray(v)) for n, v in state_dict_from_jax_params(
            jax.tree.map(np.asarray, tree[lvl]), getattr(tmodel, lvl)).items()}
            for lvl in ("coarse", "fine")}

    _assert_close_to(got["state"]["params"], named(state.params), tp["start"])
    mu, nu = named(state.opt_state[0].mu), named(state.opt_state[0].nu)
    _assert_moments_close(got["state"]["moments"],
                          {lvl: {n: (mu[lvl][n], nu[lvl][n]) for n in mu[lvl]} for lvl in mu})


def test_tp_step_matches_one_process(tp):
    """Three steps with jitter, sigma noise and importance draws from one
    generator seed, against the port's one-process step on the same draws:
    losses, parameters and Adam's moments, through ``gather_state``."""
    cfg, job = tp["cfg"], tp["job"]
    rs, seed, batches = job["runs"]["drawn"]
    nets = {}
    for level, sd in job["params"].items():
        nets[level] = NeRFMLP(getattr(job["model"], level), device="cpu")
        nets[level].load_state_dict(sd, strict=True)
    state = init_train_state(nets, cfg.lrate)
    step = make_train_step(job["model"], rs, cfg.lrate, cfg.lrate_decay)
    gen = torch.Generator().manual_seed(seed)
    losses = [float(step(state, *(torch.from_numpy(a) for a in batch), generator=gen)["loss"])
              for batch in batches]
    got = _assert_ranks_agree(tp, "drawn")
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    want = {lvl: dict(net.named_parameters()) for lvl, net in nets.items()}
    _assert_close_to(got["state"]["params"], {lvl: {n: p.detach() for n, p in ps.items()}
                                              for lvl, ps in want.items()}, tp["start"])
    _assert_moments_close(got["state"]["moments"], {
        lvl: {n: tuple(state.optimizer.state[p][k] for k in ("exp_avg", "exp_avg_sq"))
              for n, p in ps.items()} for lvl, ps in want.items()})


def test_tp_sharded_frame_matches_whole_nets(tp):
    """The mesh-sharded frame renderer on the DP×TP ranks (each data index
    its rows, through the model-parallel nets) is the unsharded frame of
    the gathered whole nets, on every rank."""
    model = tp["job"]["model"]
    nets = {}
    for lvl, sd in tp["ranks"][0]["det"]["state"]["params"].items():
        nets[lvl] = NeRFMLP(getattr(model, lvl), device="cpu")
        nets[lvl].load_state_dict(sd, strict=True)
    H, W, K, pose = tp["job"]["frame"]
    rs = tp["job"]["runs"]["det"][0].eval_mode()
    want = make_frame_renderer(model, rs, H, W, K, 2.0, 6.0, device="cpu")(nets, pose)
    for rank in tp["ranks"]:
        assert set(rank["frame"]) == set(want)
        for k in want:
            torch.testing.assert_close(rank["frame"][k], want[k], rtol=0, atol=FRAME_TOL,
                                       equal_nan=True)


@pytest.mark.parametrize("net", ["viewdirs", "no_viewdirs"])
def test_tp_mlp_grads_equal_whole_mlp(tp, net):
    """On each 2-rank model group, the model-parallel MLP's raw and its
    gathered weight grads equal the whole MLP's within GRAD_TOL (a gather
    whose backward summed over the ranks would double every sharded leaf)."""
    for rank in tp["ranks"]:
        errs = rank["grad_check"][net]
        assert len(errs) == 1 + 2 * (8 + (4 if net == "viewdirs" else 2))  # raw and every leaf
        bad = {k: e for k, e in errs.items() if not e <= GRAD_TOL}
        assert not bad, (rank["rank"], bad)


def _jax_sharding(cfg, n_model):
    """nerf_tpu's ``param_sharding(make_mesh(1, n_model), params, True)`` by
    the port's parameter names: whether 'model' splits the leaf (each leaf
    of the shardings' tree as an array of its flag, carried over by
    ``state_dict_from_jax_params``)."""
    jcfg = JMLPConfig(width=cfg.width, use_viewdirs=cfg.use_viewdirs)
    params = jax.eval_shape(lambda: jinit_params(jax.random.key(0), jcfg))
    specs = jmesh.param_sharding(jmesh.make_mesh(1, n_model, jax.devices()[:n_model]), params,
                                 True)
    flags = jax.tree.map(lambda leaf, sh: np.full(leaf.shape, "model" in tuple(sh.spec)),
                         params, specs)
    sd = state_dict_from_jax_params(flags, cfg)
    if not cfg.use_viewdirs:  # filled in by the carry-over, no leaf of nerf_tpu's
        del sd["views_linears.0.weight"], sd["views_linears.0.bias"]
    return {name: bool(t.flatten()[0]) for name, t in sd.items()}


@pytest.mark.parametrize("n_model", [2, 3, 4])
@pytest.mark.parametrize("views", [True, False])
@pytest.mark.parametrize("width", [64, 96])
def test_param_sharding_matches_nerf_tpu(width, views, n_model):
    """``param_sharding`` is nerf_tpu's leaf for leaf (the unused
    views_linears.0 without viewdirs has no leaf there); unsharded with the
    flag off or one model index."""
    cfg = MLPConfig(width=width, use_viewdirs=views)
    net = NeRFMLP(cfg, device="cpu")
    mesh = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"), n_model=n_model)
    got = param_sharding(mesh, net, True)
    want = _jax_sharding(cfg, n_model)
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == (set() if views else {"views_linears.0.weight",
                                                         "views_linears.0.bias"})
    assert not any(param_sharding(mesh, net, False).values())
    one = Mesh(group=None, size=2, rank=1, device=torch.device("cpu"))
    assert not any(param_sharding(one, net, True).values())


def test_tp_step_refuses_kernels_and_whole_nets():
    """With n_model > 1 the DP×TP step runs the plain MLP: a model with its
    kernels on raises, as does a state that ``shard_state`` did not make;
    with n_model 1 (or the flag off) the flag changes nothing."""
    cfg = MLPConfig(width=64)
    plain = NeRFModel(PosEncConfig(10), PosEncConfig(4), cfg, cfg)
    rs = RenderSettings(n_samples=8, n_importance=8, perturb=False)
    cpu = torch.device("cpu")
    mesh = Mesh(group=None, size=1, rank=0, device=cpu, n_model=2)
    for flags in ({"fused": True}, {"fused_render": True}):
        with pytest.raises(ValueError, match="runs the plain MLP"):
            make_sharded_train_step(mesh, dataclasses.replace(plain, **flags), rs, 5e-4, 250,
                                    shard_model_axis=True)
        make_sharded_train_step(mesh, dataclasses.replace(plain, **flags), rs, 5e-4, 250)
    one = Mesh(group=None, size=1, rank=0, device=cpu)
    assert (one.data_index, one.model_index, one.data_group) == (0, 0, None)
    make_sharded_train_step(one, dataclasses.replace(plain, fused=True), rs, 5e-4, 250,
                            shard_model_axis=True)
    state = init_train_state({"coarse": NeRFMLP(cfg, device=cpu)}, 5e-4)
    assert shard_state(one, state) is state
    step = make_sharded_train_step(mesh, plain, rs, 5e-4, 250, shard_model_axis=True)
    rays = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shard_state"):
        step(state, rays, rays, torch.full((4,), 2.0), torch.full((4,), 6.0), rays)
