"""Multi-scene throughput sweep on the card: S scenes trained as one
program against the same scenes trained one after another.

Counterpart of tools/multiscene_sweep.py (nerf_tpu's BASELINE config #5):

    python -m nerf_tpu_torch.tools.make_multi_scenes
    python -m nerf_tpu_torch.tools.multiscene_sweep [--n_iters 2000] [--scenes 8] \
        [--out multiscene_sweep.json] [config overrides ...]

Run it from a directory that holds configs/multi/scene_{k}.txt and their
datadirs, which are relative (the repository root, once the scenes are
written). It trains S in (1, 2, 4, 8) of the scenes (S <= --scenes)
CONCURRENTLY, in chunks of FUSE steps of [the ``StackedImageSampler``
draws -> the stacked step] (parallel/multi_scene.py), each chunk one CUDA
graph replay (train/graph.py's ``ChunkRunner``; one graph an S, as
nerf_tpu compiles one program an S). Then it trains the --scenes scenes
SEQUENTIALLY through the S = 1 graph: each scene's train views, rays and
fresh state are copied into that graph's static buffers. After each run
it renders every scene's first holdout view (``i_val[0]``) in eval mode
for its PSNR. n_iters is rounded down to a multiple of FUSE, and is at
least two chunks. A run's first chunk warms up (at a new S it captures the
graph) and is not timed; the rest are timed between
``torch.cuda.synchronize()`` fences, in place of nerf_tpu's value
fetches. The tool prints a ``[SWEEP]`` line a run and writes nerf_tpu's
JSON record to --out, with the card added (nvidia-smi's name and power
limit).

Scene k's streams do not depend on S. Its nets start from seed
``scene_seed(seed, k)``, and its sampler and its step draw from
generators seeded one and two above that. These are the counterparts of
nerf_tpu's ``init_keys[k]``, ``sample_keys[k]`` and ``step_keys_all[k]``.
Every run sets ``--precrop_iters 0``, as nerf_tpu's does, so every chunk
draws from the full frame.

What nerf_tpu's tool lacks: argv other than --n_iters, --scenes and --out
goes to ``load_config`` after each scene's config, unchanged, so a test
can shrink the net. ``main(argv, device="cpu")`` runs the chunks eagerly
on the CPU (the graph's plain version). With no device, ``main`` runs on
the card and raises where there is none. It returns the record and each
run's per-step losses and trained weights (``SweepResult``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from nerf_tpu_torch.config import NeRFConfig, load_config
from nerf_tpu_torch.data.scene import Scene
from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.models.factory import make_model
from nerf_tpu_torch.parallel.multi_scene import (
    StackedImageSampler, init_multi_scene_state, make_multi_scene_step, scene_seed,
    unstack_states,
)
from nerf_tpu_torch.render.renderer import make_frame_renderer
from nerf_tpu_torch.train.graph import ChunkRunner
from nerf_tpu_torch.train.loop import load_scene, render_settings_from_config
from nerf_tpu_torch.train.step import lr_schedule
from nerf_tpu_torch.utils.metrics import img2mse, mse2psnr

FUSE = 50  # steps a chunk (the production fuse_steps default)
CONCURRENT = (1, 2, 4, 8)
FLAGS = {"--n_iters": 2000, "--scenes": 8, "--out": "multiscene_sweep.json"}


def parse_args(argv: Sequence[str]):
    """(n_iters, scenes, out, the rest): nerf_tpu's three flags, each with
    its value (``--flag v`` or ``--flag=v``); the rest, in order, for
    ``load_config``."""
    values, rest, i = dict(FLAGS), [], 0
    argv = list(argv)
    while i < len(argv):
        name, eq, value = argv[i].partition("=")
        if name not in FLAGS:
            rest.append(argv[i])
            i += 1
            continue
        if not eq:
            if i + 1 >= len(argv):
                raise SystemExit(f"{name} requires a value, e.g. {name} {FLAGS[name]}")
            value = argv[i + 1]
            i += 1
        values[name] = value
        i += 1
    return int(values["--n_iters"]), int(values["--scenes"]), str(values["--out"]), rest


def card_name() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


class Pack:
    """The runner of S scenes: static buffers (the stacked sampler's train
    views and rays, the stacked state, each scene's sampler and step
    generators, on the device) and a ``ChunkRunner`` of ``k`` steps over
    them. On a card its graph, captured at the first chunk, replays
    whatever scenes ``load`` last put in the buffers."""

    def __init__(self, cfg: NeRFConfig, scenes: Sequence[Scene], seeds: Sequence[int], k: int,
                 lr_table: torch.Tensor, device: torch.device):
        S, n_rand = len(scenes), cfg.N_rand
        self.cfg, self.device = cfg, device
        self.model = make_model(cfg)
        rs = render_settings_from_config(cfg)
        self.sample_gens = [torch.Generator(device=device) for _ in range(S)]
        self.step_gens = [torch.Generator(device=device) for _ in range(S)]
        self.sampler = StackedImageSampler(scenes, n_rand, self.sample_gens, device=device)
        self.state = init_multi_scene_state(self.model, seeds, cfg.lrate, device)
        step = make_multi_scene_step(self.model, rs, cfg.lrate, cfg.lrate_decay, S)
        near = torch.full((S, n_rand), scenes[0].near, dtype=torch.float32, device=device)
        far = torch.full((S, n_rand), scenes[0].far, dtype=torch.float32, device=device)
        self.runner = ChunkRunner(functools.partial(step, generators=self.step_gens), self.state,
                                  k, near, far, [*self.step_gens, *self.sample_gens],
                                  lr_table, 0)
        self._seed(seeds)

    def _seed(self, seeds: Sequence[int]) -> None:
        for g, s in zip(self.sample_gens, seeds):
            g.manual_seed(s + 1)
        for g, s in zip(self.step_gens, seeds):
            g.manual_seed(s + 2)

    def load(self, scenes: Sequence[Scene], seeds: Sequence[int]) -> None:
        """Put ``scenes``' train views and rays, their fresh states (nets
        from ``seeds``, Adam's moments and counts zero, step 0) and their
        generators' first states in the buffers, in place."""
        views = StackedImageSampler(scenes, self.cfg.N_rand, self.sample_gens,
                                    device=self.device)
        fresh = init_multi_scene_state(self.model, seeds, self.cfg.lrate, self.device)
        with torch.no_grad():
            for name in ("images", "origins", "rays_d"):
                getattr(self.sampler, name).copy_(getattr(views, name))
            for level, net in self.state.nets.items():
                for p, q in zip(net.parameters(), fresh.nets[level].parameters()):
                    p.copy_(q)
            for held in self.state.optimizer.state.values():
                for v in held.values():
                    v.zero_()
        self.state.step = 0
        self._seed(seeds)

    def chunk(self) -> Dict[str, torch.Tensor]:
        """The k steps from ``state.step``; each aux value [k, S]."""
        i = self.state.step + 1
        aux = self.runner.run("full", lambda j, _: self.sampler.next_batch(i + j))
        self.sampler.advance(self.runner.k)
        return aux


@dataclasses.dataclass
class Run:
    """One run of the sweep: its scenes, the wall seconds of its timed
    chunks, each step's loss [n_iters, S] and each scene's trained
    parameters by level and name (on the CPU)."""

    label: str
    scenes: List[int]
    seconds: float
    steps: int
    psnrs: List[float]
    losses: np.ndarray
    params: List[Dict[str, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class SweepResult:
    record: dict  # the JSON record
    runs: List[Run]  # the concurrent runs by S, then the sequential runs scene by scene


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, device: DeviceLike = None) -> SweepResult:
    """Run the sweep (see the module's docstring) on ``device``, the card
    unless told otherwise."""
    n_iters, n_scenes, out, rest = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    n_iters = max(2 * FUSE, n_iters - n_iters % FUSE)  # a warm-up chunk + one timed at least
    cfgs = [load_config(["--config", f"configs/multi/scene_{k}.txt", *rest,
                         "--precrop_iters", "0"]) for k in range(n_scenes)]
    c0 = cfgs[0]
    scenes = [load_scene(c) for c in cfgs]
    s0 = scenes[0]
    H, W, n_rand = s0.H, s0.W, c0.N_rand
    seeds = [scene_seed(c0.seed, k) for k in range(n_scenes)]
    schedule = lr_schedule(c0.lrate, c0.lrate_decay)
    lr_table = torch.tensor([schedule(t) for t in range(n_iters)], dtype=torch.float32,
                            device=dev)
    packs: Dict[int, Pack] = {}
    model = make_model(c0)
    rs = render_settings_from_config(c0)
    # one frame renderer for every holdout view (one H, W and K)
    render_frame = make_frame_renderer(model, rs.eval_mode(), H, W, s0.K, s0.near, s0.far,
                                       chunk=c0.chunk, device=dev)

    def holdout_psnr(nets, scene: Scene) -> float:
        i_val = int(np.asarray(scene.i_val)[0])
        frame = render_frame(nets, np.asarray(scene.poses[i_val])[:3, :4])
        target = torch.as_tensor(np.asarray(scene.images[i_val], np.float32), device=dev)
        return float(mse2psnr(img2mse(frame["rgb_map"], target)))

    def run_scenes(ids: List[int], label: str) -> Run:
        """Train ``ids`` concurrently for n_iters steps."""
        S = len(ids)
        mine = [scenes[k] for k in ids]
        if S in packs:
            packs[S].load(mine, [seeds[k] for k in ids])
        else:
            packs[S] = Pack(c0, mine, [seeds[k] for k in ids], FUSE, lr_table, dev)
        pack = packs[S]
        losses = [pack.chunk()["loss"]]  # warm-up (and capture): not timed
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n_iters // FUSE - 1):
            losses.append(pack.chunk()["loss"])
        _sync(dev)
        dt = time.perf_counter() - t0
        states = unstack_states(pack.state, S)
        psnrs = [holdout_psnr(st.nets, scenes[k]) for st, k in zip(states, ids)]
        params = [{level: {n: p.detach().cpu() for n, p in net.named_parameters()}
                   for level, net in st.nets.items()} for st in states]
        return Run(label, ids, dt, n_iters - FUSE, psnrs,
                   torch.cat(losses).cpu().numpy(), params)

    card = card_name() if dev.type == "cuda" else None
    results = {"n_iters": n_iters, "fuse": FUSE, "n_rand": n_rand,
               "samples": f"{c0.N_samples}+{c0.N_importance}", "res": f"{H}x{W}",
               "device": dev.type, "card": card, "runs": []}
    runs = []
    for S in CONCURRENT:
        if S > n_scenes:
            continue
        run = run_scenes(list(range(S)), f"concurrent_S{S}")
        runs.append(run)
        agg = run.steps * S * n_rand / run.seconds
        row = {"label": run.label, "S": S,
               "ms_per_step": round(run.seconds / run.steps * 1e3, 3),
               "agg_rays_per_sec": round(agg), "per_scene_rays_per_sec": round(agg / S),
               "holdout_psnr": [round(p, 2) for p in run.psnrs]}
        results["runs"].append(row)
        print(f"[SWEEP] S={S}: {row['ms_per_step']} ms/step  {agg:,.0f} rays/s agg  "
              f"PSNR {row['holdout_psnr']}", flush=True)

    # sequential: the same per-scene work (seeds, generators, the S = 1
    # graph), scene after scene
    seq = [run_scenes([k], f"sequential_{k}") for k in range(n_scenes)]
    runs.extend(seq)
    t_total = sum(r.seconds for r in seq)
    agg_seq = n_scenes * seq[0].steps * n_rand / t_total
    row = {"label": f"sequential_{n_scenes}x", "S": 1, "total_wall_s": round(t_total, 2),
           "agg_rays_per_sec": round(agg_seq),
           "holdout_psnr": [round(p, 2) for r in seq for p in r.psnrs]}
    results["runs"].append(row)
    print(f"[SWEEP] sequential x{n_scenes}: {t_total:.1f}s total, {agg_seq:,.0f} rays/s agg  "
          f"PSNR {row['holdout_psnr']}  ({card or dev.type})", flush=True)

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results["runs"], indent=1), flush=True)
    return SweepResult(results, runs)


if __name__ == "__main__":
    main()
