"""The data-parallel train step timed on the cards: n ranks, a card each,
step by step and fused.

    python -m nerf_tpu_torch.tools.dp_time [n ...]

For each rank count n (default: 1, 2, 4, ... up to the visible cards) the
tool builds the kernels, then spawns n ranks joined by NCCL
(``parallel.distributed.launch``). Each runs ``parallel/mesh.py``'s sharded
step at the lego recipe (configs/lego.txt: 8x256 with viewdirs, 64+128
samples, white background, bf16, its sampler: one image a step, the centre
crop first), N_rand 4096 over all ranks, so 4096 / n rays a rank, on 8
white 400x400 views of the orbit, with seed-0 weights (``time_rank``):

- step by step: WARMUP steps, then WINDOWS windows of STEPS steps between
  card syncs (ms/step: their median), then PROFILED steps under
  torch.profiler;
- fused, as ``train()`` runs it (train/graph.py's ``ChunkRunner``, NCCL's
  all-reduces inside each rank's graph): a chunk of FUSE steps that
  captures, then WINDOWS windows of one chunk, then PROFILED_CHUNKS chunks
  under the profiler;

each with its device ms/step, that of NCCL's kernels (the all-reduce) and
the device's idle share over the profiled window, and the rank's peak
memory. Then ``check_rank``: ``train()`` on the same ranks for
CHECK_CHUNKS chunks of CHECK_K steps with ``fuse_steps`` CHECK_K and with
1, on 8 views of seeded noise: whether history, parameters and Adam's
state are ``torch.equal``, with the chunks, CUDA graph replays and kernel
launches of each run. Prints one JSON line a rank count (rank 0's times,
every rank's check), with the card's name and power limit. NCCL's
settings come from the environment: to pin its algorithm for both runs of
the check, set e.g. ``NCCL_ALGO=Ring`` on the command line. The tool
imports only ``nerf_tpu_torch``; run as a file with another checkout's root
on ``PYTHONPATH`` it times that checkout (one without the fused loop over
ranks fails at the fused part).
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

LEGO = Path(__file__).resolve().parents[2] / "configs" / "lego.txt"
N_RAND = 4096
H = W = 400
FOCAL = 555.555
VIEWS = 8
WARMUP, WINDOWS, STEPS, PROFILED = 3, 5, 10, 3
FUSE, PROFILED_CHUNKS = 10, 2
CHECK_K, CHECK_CHUNKS = 4, 2


def views(images: np.ndarray):
    """``images`` [VIEWS, H, W, 3] on the lego orbit as a Scene (the
    recipe's sampler draws from all of them)."""
    from nerf_tpu_torch.data.scene import Scene, default_intrinsics
    from nerf_tpu_torch.geom.poses import spherical_render_poses

    poses = np.asarray(spherical_render_poses(40))[:: 40 // VIEWS][:VIEWS, :3, :4]
    return Scene(images=images.astype(np.float32), poses=poses.astype(np.float32),
                 render_poses=poses, hwf=(H, W, FOCAL), K=default_intrinsics(H, W, FOCAL),
                 i_train=np.arange(VIEWS), i_val=np.zeros(0, int), i_test=np.zeros(0, int),
                 near=2.0, far=6.0)


def peak_gib(dev):
    """The card's peak allocated memory since its last reset, GiB."""
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def profiled(run, n_steps: int, dev) -> dict:
    """``run()`` (``n_steps`` steps) under torch.profiler, between card
    syncs: device ms/step, NCCL's share, the idle share of the window."""
    from nerf_tpu_torch.utils.profiler import device_rows

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    nccl = [(us, key) for us, key, _ in rows if "nccl" in key.lower()]
    return {"out": out, "wall_ms_per_step": wall_us / 1e3 / n_steps,
            "device_ms_per_step": busy_us / 1e3 / n_steps,
            "allreduce_ms_per_step": sum(us for us, _ in nccl) / 1e3 / n_steps,
            "allreduce_kernels": sorted({key[:60] for _, key in nccl}),
            "idle_share": max(0.0, 1 - busy_us / wall_us) if busy_us else None}


def time_rank(device, warmup: int = WARMUP, windows: int = WINDOWS, steps: int = STEPS,
              profiled_steps: int = PROFILED, fuse: int = FUSE,
              profiled_chunks: int = PROFILED_CHUNKS) -> dict:
    """One rank's share: see the module's docstring (``fuse`` 0: no fused
    part). Every rank of the process group calls it."""
    import torch.distributed as dist

    from nerf_tpu_torch.config import load_config
    from nerf_tpu_torch.data.rays_dataset import make_sampler
    from nerf_tpu_torch.models.factory import init_nets, make_model
    from nerf_tpu_torch.parallel import distributed
    from nerf_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step, place_state
    from nerf_tpu_torch.train.graph import ChunkRunner
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.step import init_train_state, lr_schedule

    cfg = load_config([f"--config={LEGO}", f"--N_rand={N_RAND}"])
    mesh = make_mesh(distributed.world_size(), device=device)
    dev = mesh.device
    scene = views(np.ones((VIEWS, H, W, 3), np.float32))
    model = make_model(cfg)
    state = place_state(mesh, init_train_state(init_nets(model, cfg.seed, dev), cfg.lrate))
    step = make_sharded_train_step(mesh, model, render_settings_from_config(cfg), cfg.lrate,
                                   cfg.lrate_decay)
    sampler = make_sampler(scene, cfg, torch.Generator(device=dev).manual_seed(cfg.seed + 1),
                           device=dev, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 2)
    rows = N_RAND // mesh.size
    near = torch.full((rows,), scene.near, device=dev)
    far = torch.full((rows,), scene.far, device=dev)

    def sync():  # the card's queue (a CPU rank has none)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one():
        ro, rd, target = sampler.next_batch(state.step + 1)
        return step(state, ro, rd, near, far, target, generator=gen)

    def windowed(run, n_steps: int) -> list:
        out = []
        for _ in range(windows):
            sync()
            distributed.barrier(mesh.group)
            t0 = time.perf_counter()
            run()
            sync()
            out.append(1e3 * (time.perf_counter() - t0) / n_steps)
        return out

    def steps_of(n):
        def run():
            aux = None
            for _ in range(n):
                aux = one()
            return aux
        return run

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(warmup):
        one()
    window_ms = windowed(steps_of(steps), steps)
    prof = profiled(steps_of(profiled_steps), max(profiled_steps, 1), dev)
    aux = prof.pop("out")
    out = {"ranks": mesh.size, "rays_per_rank": rows, "device": str(dev),
           "ms_per_step": float(np.median(window_ms)) if window_ms else None,
           "window_ms_per_step": window_ms,
           "loss": float(aux["loss"]) if profiled_steps else None,
           **{k: v for k, v in prof.items() if k != "wall_ms_per_step"},
           "profiled_wall_ms_per_step": prof["wall_ms_per_step"], "peak_gib": peak_gib(dev)}

    if fuse:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        schedule = lr_schedule(cfg.lrate, cfg.lrate_decay)
        n = fuse * (1 + windows + profiled_chunks)
        table = torch.tensor([schedule(state.step + t) for t in range(n)], dtype=torch.float32,
                             device=dev)
        runner = ChunkRunner(functools.partial(step, generator=gen), state, fuse, near, far,
                             [gen, sampler.generator], table, state.step)
        if dev.type == "cuda":
            distributed.connect(mesh.group, dev)

        def chunks_of(c):
            def run():
                for _ in range(c):
                    i = state.step + 1  # the crop phase: precrop_iters 500
                    aux = runner.run("crop", lambda j, _, i=i: sampler.next_batch(i + j))
                return aux
            return run

        chunks_of(1)()  # captures
        fused_ms = windowed(chunks_of(1), fuse)
        prof = profiled(chunks_of(profiled_chunks), fuse * profiled_chunks, dev)
        aux = prof.pop("out")
        out.update({
            "fuse_steps": fuse,
            "fused_ms_per_step": float(np.median(fused_ms)) if fused_ms else None,
            "fused_window_ms_per_step": fused_ms, "fused_loss": float(aux["loss"][-1]),
            **{f"fused_{k}": v for k, v in prof.items()}, "replays": runner.replays,
            "fused_peak_gib": peak_gib(dev)})
    ones = torch.ones(8, device=dev)
    dist.all_reduce(ones, group=mesh.group)
    out["all_reduce_of_ones"] = ones.tolist()
    return out


@contextlib.contextmanager
def counted_replays():
    """While inside, count ``torch.cuda.CUDAGraph.replay`` calls."""
    record = {"replays": 0}
    replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        record["replays"] += 1
        return replay(graph)

    torch.cuda.CUDAGraph.replay = counted
    try:
        yield record
    finally:
        torch.cuda.CUDAGraph.replay = replay


def check_rank(device, scene=None, k: int = CHECK_K, chunks: int = CHECK_CHUNKS,
               dtype: str = "bfloat16") -> dict:
    """``train()`` in this rank's group at the lego recipe (N_rand 4096 over
    the ranks, ``dtype``) for ``chunks`` chunks of ``k`` steps (i_print k,
    no other event) with ``fuse_steps`` k and then with 1, from the same
    seed, on ``scene`` (default: 8 views of seeded noise): ``equal``
    (history, parameters and Adam's state ``torch.equal``), each run's
    chunks, CUDA graph replays and kernel launches (the wrappers' counts,
    train/graph.py's ``launch_counters``, by name), history and the
    ``[FUSE]``/``[MESH]`` lines. Every rank of the group calls it."""
    from nerf_tpu_torch.config import load_config
    from nerf_tpu_torch.train.graph import launch_counters
    from nerf_tpu_torch.train.loop import train

    if scene is None:
        scene = views(np.random.default_rng(0).uniform(0, 1, (VIEWS, H, W, 3)))
    counters = launch_counters()
    basedir = tempfile.mkdtemp(prefix="dp_check_")
    runs = {}
    try:
        for name, fuse in (("fused", k), ("per_step", 1)):
            cfg = load_config([
                f"--config={LEGO}", f"--N_rand={N_RAND}", f"--n_iters={k * chunks}",
                f"--fuse_steps={fuse}", f"--i_print={k}", "--i_img=0", "--i_weights=0",
                "--i_testset=0", "--i_video=0", f"--compute_dtype={dtype}",
                f"--basedir={basedir}", f"--expname={name}"])
            before = [getattr(o, a) for o, a in counters]
            log = io.StringIO()
            with counted_replays() as rec, contextlib.redirect_stdout(log):
                result = train(cfg, scene, device=device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            launches = {getattr(o, "__name__", str(o)): getattr(o, a) - b
                        for (o, a), b in zip(counters, before) if getattr(o, a) != b}
            runs[name] = {"result": result, "chunks": result.chunks,
                          "replays": rec["replays"], "launches": launches,
                          "lines": [ln for ln in log.getvalue().splitlines()
                                    if ln.startswith(("[FUSE]", "[MESH]"))]}
    finally:
        shutil.rmtree(basedir, ignore_errors=True)
    a, b = runs["fused"]["result"], runs["per_step"]["result"]
    equal = a.history == b.history and a.state.step == b.state.step == k * chunks
    for level in ("coarse", "fine"):
        for p, q in zip(a.state.nets[level].parameters(), b.state.nets[level].parameters()):
            sp, sq = a.state.optimizer.state[p], b.state.optimizer.state[q]
            equal = equal and torch.equal(p, q) and all(torch.equal(sp[s], sq[s]) for s in sq)
    return {"device": str(device), "equal": equal,
            "history": [(i, loss) for i, loss, _ in a.history],
            **{name: {key: v for key, v in run.items() if key != "result"}
               for name, run in runs.items()}}


def rank_main(device) -> dict:
    return {"time": time_rank(device), "check": check_rank(device)}


def main(argv=None) -> int:
    from nerf_tpu_torch.ops import _build
    from nerf_tpu_torch.parallel import distributed

    if not torch.cuda.is_available():
        print("dp_time: no CUDA device", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    counts = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    counts = counts or [n for n in (1, 2, 4, 8, 16) if n <= cards]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    _build.load_all(["fused_mlp_fwd", "fused_mlp_bwd"])  # once, before the ranks start
    for n in counts:
        ranks = distributed.launch(rank_main, n, "cuda")
        print(json.dumps({"card": smi, "cards": cards, "n_rand": N_RAND, **ranks[0]["time"],
                          "check": [r["check"] for r in ranks]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
