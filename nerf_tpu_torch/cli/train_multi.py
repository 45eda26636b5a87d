"""Multi-scene training CLI: S scenes as one stacked step.

Counterpart of nerf_tpu/cli/train_multi.py:

    python -m nerf_tpu_torch.cli.train_multi --configs configs/multi/scene_0.txt \
        configs/multi/scene_1.txt [--n_iters N] [--data_axis D] [...overrides]

Every scene trains with the hyperparameters of its own config file; the
model shape, the sample counts, the batch and the background must agree
across scenes (one stacked step; the CLI exits naming the field that does
not), and so must NDC. Each level of the step takes the branch one scene
would take, stacked (parallel/multi_scene.py): the stacked K1 and K4, K2
and K3 (sample counts that are not multiples of 8) or K5 and K6
(``--fused_render``), each launched once for every scene, or the stacked
plain MLP (``fused_kernels`` off, no viewdirs). Scene k
starts from seed ``scene_seed(seed, k)`` of the first config's seed and
draws from its own generators, so it trains as ``cli.train`` would with
that seed. Every i_print steps a ``[TRAIN-MULTI]`` line gives each scene's
loss and PSNR; every i_weights steps each scene's state goes to its own
``basedir/expname/{step:06d}.tar`` (utils/checkpoint.py), which loads into
the one-scene model, ``cli.train`` and ``cli.render``.

``--data_axis n`` > 1, with n dividing S, trains over n ranks, a card each
(``parallel.distributed.launch``, or the group this process is started
in): rank r owns scenes r*S/n .. (r+1)*S/n - 1, and the ranks never
communicate. Otherwise, as in nerf_tpu, one process trains every scene.
On the CPU (``main(..., device="cpu")``) the ranks are gloo processes.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from nerf_tpu_torch.cli import train as cli_train
from nerf_tpu_torch.config import NeRFConfig, load_config
from nerf_tpu_torch.data.rays_dataset import make_sampler
from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.models.factory import make_model
from nerf_tpu_torch.parallel import distributed
from nerf_tpu_torch.parallel.mesh import make_mesh
from nerf_tpu_torch.parallel.multi_scene import (
    StackedImageSampler, init_multi_scene_state, make_multi_scene_step,
    make_sharded_multi_scene_step, scene_seed, shard_scene_axis, unstack_states,
)
from nerf_tpu_torch.train.loop import load_scene, render_settings_from_config
from nerf_tpu_torch.train.step import TrainState
from nerf_tpu_torch.utils import checkpoint as ckpt_lib

# the fields that make the stacked step (nerf_tpu's one compiled program)
SHARED = ("N_rand", "N_samples", "N_importance", "netdepth", "netwidth", "use_viewdirs",
          "white_bkgd", "no_batching")


def _split_argv(argv):
    """Pull `--configs a b c` out of argv; return (config_paths, rest)."""
    if "--configs" not in argv:
        raise SystemExit("train_multi requires --configs cfg1.txt [cfg2.txt ...]")
    i = argv.index("--configs")
    paths, j = [], i + 1
    while j < len(argv) and not argv[j].startswith("--"):
        paths.append(argv[j])
        j += 1
    return paths, argv[:i] + argv[j:]


def load_configs(argv: Sequence[str]) -> List[NeRFConfig]:
    """The scenes' configs, each file under the shared flags of ``argv``;
    exits naming the first field that differs where one step needs it the
    same, or NDC that differs."""
    paths, rest = _split_argv(list(argv))
    cfgs = [load_config(["--config", p] + rest) for p in paths]
    c0 = cfgs[0]
    for c in cfgs[1:]:
        for f in SHARED:
            if getattr(c, f) != getattr(c0, f):
                raise SystemExit(
                    f"all scenes must share {f} (one stacked step); "
                    f"{c.expname}={getattr(c, f)} vs {c0.expname}={getattr(c0, f)}")
        if c.ndc != c0.ndc:
            raise SystemExit("all scenes must agree on NDC (llff forward-facing) vs not: "
                             "one stacked step")
    return cfgs


@dataclasses.dataclass
class MultiTrainResult:
    state: TrainState  # stacked: this process's scenes
    scenes: List[int]  # their indices among the configs
    history: list  # [(step, losses [scenes], psnrs [scenes])] at each i_print


def _stackable(scenes, cfgs) -> bool:
    """nerf_tpu's test for one stacked sampler: no_batching, scenes of one
    shape, and one precrop schedule."""
    s0, c0 = scenes[0], cfgs[0]
    return c0.no_batching and all(
        s.images.shape == s0.images.shape and s.poses.shape == s0.poses.shape
        and len(s.i_train) == len(s0.i_train) for s in scenes) and all(
        (c.precrop_iters, c.precrop_frac) == (c0.precrop_iters, c0.precrop_frac) for c in cfgs)


def train_multi(cfgs: Sequence[NeRFConfig], device: DeviceLike = None,
                hooks: Optional[Dict[str, Callable]] = None) -> MultiTrainResult:
    """Train the configs' scenes as one stacked step on the card unless
    ``device`` says otherwise; inside a process group of n ranks, this
    rank's S/n scenes. ``hooks["on_step"](i, state, aux)`` runs after each
    step's events."""
    hooks = hooks or {}
    c0, S = cfgs[0], len(cfgs)
    dev = resolve_device(device)
    world = distributed.world_size()
    mesh = make_mesh(world, device=dev) if world > 1 else None
    if mesh is not None:
        if S % world:
            raise ValueError(f"{S} scenes do not divide over the group's {world} ranks")
        dev = mesh.device
    mine = list(range(S)) if mesh is None else shard_scene_axis(mesh, list(range(S)))
    model = make_model(c0)
    rs = render_settings_from_config(c0)
    my_cfgs = [cfgs[k] for k in mine]
    scenes = [load_scene(c) for c in my_cfgs]
    seeds = [scene_seed(c0.seed, k) for k in mine]
    state = init_multi_scene_state(model, seeds, c0.lrate, dev)
    n = len(mine)
    if mesh is None:
        step = make_multi_scene_step(model, rs, c0.lrate, c0.lrate_decay, S)
    else:
        step = make_sharded_multi_scene_step(mesh, model, rs, c0.lrate, c0.lrate_decay, S)
        print(f"[MESH] {S} scenes over {world} ranks, rank {mesh.rank}: scenes {mine}",
              flush=True)

    def generators(offset):
        return [torch.Generator(device=dev).manual_seed(s + offset) for s in seeds]

    stacked = samplers = None
    if _stackable(scenes, my_cfgs):
        stacked = StackedImageSampler(scenes, c0.N_rand, generators(1), c0.precrop_iters,
                                      c0.precrop_frac, device=dev)
    else:
        samplers = [make_sampler(s, c, g, device=dev)
                    for s, c, g in zip(scenes, my_cfgs, generators(1))]
    step_gens = generators(2)
    bounds = [(0.0, 1.0) if rs.ndc else (s.near, s.far) for s in scenes]
    near = torch.tensor([[b[0]] * c0.N_rand for b in bounds], dtype=torch.float32, device=dev)
    far = torch.tensor([[b[1]] * c0.N_rand for b in bounds], dtype=torch.float32, device=dev)
    hwf = None
    if rs.ndc:  # each scene's own intrinsics, per ray (nerf_tpu's hwf operand)
        hwf = torch.tensor([[s.H, s.W, s.focal] for s in scenes], dtype=torch.float32,
                           device=dev)

    history = []
    t0 = time.perf_counter()
    for i in range(1, c0.n_iters + 1):
        if stacked is not None:
            ro, rd, tgt = stacked.next_batch(i)
        else:
            batches = [smp.next_batch(i) if c.no_batching else smp.next_batch()
                       for smp, c in zip(samplers, my_cfgs)]
            ro, rd, tgt = (torch.stack(x) for x in zip(*batches))
        aux = step(state, ro, rd, near, far, tgt, generators=step_gens, hwf=hwf)
        if i % c0.i_print == 0:
            losses = aux["loss"].cpu().numpy()  # the fetch waits for step i
            psnrs = aux["psnr"].cpu().numpy()
            now = time.perf_counter()
            rate = c0.i_print * c0.N_rand * n / max(now - t0, 1e-9)
            pairs = "  ".join(f"{c.expname}: loss {l:.5f} psnr {p:.2f}"
                              for c, l, p in zip(my_cfgs, losses, psnrs))
            print(f"[TRAIN-MULTI] Iter {i} ({rate:,.0f} rays/s agg)  {pairs}", flush=True)
            history.append((i, losses.copy(), psnrs.copy()))
            t0 = time.perf_counter()
        if c0.i_weights > 0 and i % c0.i_weights == 0:
            for c, st in zip(my_cfgs, unstack_states(state, n)):
                path = ckpt_lib.save_checkpoint(c.basedir, c.expname, st)
                print("Saved checkpoints at", path, flush=True)
            t0 = time.perf_counter()  # keep the saves out of the rate
        if "on_step" in hooks:
            hooks["on_step"](i, state, aux)
    return MultiTrainResult(state=state, scenes=mine, history=history)


def _train_rank(device, cfgs) -> MultiTrainResult:
    return train_multi(cfgs, device=device)


def run(cfgs: Sequence[NeRFConfig], device: DeviceLike = None):
    """Train the scenes in the process group this process is started in,
    else over the ``data_axis`` ranks when they divide the scenes (launched
    here; a list of their results, rank 0 first, on the CPU), else in this
    process."""
    c0 = cfgs[0]
    if distributed.initialize(c0.coordinator_address, c0.num_processes, c0.process_id,
                              device=device):
        return train_multi(cfgs, device=device)
    n = cli_train.data_ranks(c0, device)
    if n > 1 and len(cfgs) % n == 0:
        cli_train.prebuild(c0, device)
        return distributed.launch(_train_rank, n, device, args=(list(cfgs),))
    return train_multi(cfgs, device=device)


def main(argv=None, device: DeviceLike = None):
    """Parse ``argv`` and train on ``device`` (the card unless told otherwise)."""
    return run(load_configs(sys.argv[1:] if argv is None else argv), device)


if __name__ == "__main__":
    main()
