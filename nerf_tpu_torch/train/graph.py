"""The fused training loop's chunks: k steps of sampler and step, on a card
as one CUDA graph (nerf_tpu's ``fuse_steps``, its lax.scan of k steps,
nerf_tpu/train/loop.py:420-511; ROADMAP A.3), in one process or on each
rank of an NCCL group (the sharded step, parallel/mesh.py: its gradient
and loss all-reduces go into the graph; ROADMAP A.3b), and for S scenes
at once (the stacked step with its ``StackedImageSampler``,
parallel/multi_scene.py; nerf_tpu's sweep scans its vmapped step,
tools/multiscene_sweep.py:112-126). The caller binds the step's draws
(``generator=`` of the one-scene step, ``generators=`` of the stacked
one, one a scene) and hands the runner every generator a chunk draws on.

``ChunkRunner.run(phase, sample, window)`` makes the k steps that start at
the train state's step. Step j takes its batch from ``sample(j, window)``
(the batching policy gathers row j of the [k, n_rand] index window; the
image policy draws on its generator with the chunk's crop) and its learning
rate from the schedule's float32 table, a device tensor made once, so
nothing a chunk reads comes from the host while it runs. It returns each
aux value stacked over the k steps.

On a CUDA device each ``phase`` (the batching policy's one, the image
policy's crop and full frame) gets one ``torch.cuda.CUDAGraph`` of the k
steps, captured at its first chunk: one step runs first on a side stream to
do what a first call does outside the capture (the kernels' builds, Adam's
state, the libraries' handles) and is then undone (parameters, Adam's
moments and counts, the generators, ``state.step`` and the launch counts
are put back), so it is no step of the run. The graphs share one memory
pool; the inputs are static buffers, the window and the k learning rates,
filled by device copies before each replay; the step's and the sampler's
generators are registered with each graph, so a replay draws what the
eager steps would. A chunk is exactly one ``replay()``. A capture records
each wrapper's launch counts once, and every replay adds them
(``launch_counters``), so the counts read what ran. A failed capture or
replay raises: nothing falls back to eager steps on a card. A replay bumps
the parameters' version counters, as the eager steps' in-place updates do.

Over ranks every rank makes the same chunks (the loop's rule reads only
the config), so each runs the warm-up step and its undo at the same chunk,
its all-reduces paired with the other ranks', captures the same
collectives in the same order, and replays each graph when the others do.
The group's communicator exists before the first capture
(``distributed.connect``).

On the CPU the same k steps run eagerly, from the same inputs: the graph's
plain version, which the tests hold to the per-step loop bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from nerf_tpu_torch.train.step import TrainState

Sample = Callable[[int, torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def launch_counters() -> List[Tuple[object, str]]:
    """(owner, attribute) of every count a step may advance: each kernel
    wrapper's ``launches`` (ops/fused_mlp.py, ops/fused_mlp_wide.py,
    experimental/fused_render.py) and the plain MLPs' ``plain_calls``."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp, fused_mlp_wide
    from nerf_tpu_torch.render.network import StackedNeRFMLP

    owners = {id(fn): fn for mod in (fused_mlp, fused_mlp_wide, fused_render)
              for fn in vars(mod).values() if callable(fn) and hasattr(fn, "launches")}
    return ([(fn, "launches") for fn in owners.values()]
            + [(NeRFMLP, "plain_calls"), (StackedNeRFMLP, "plain_calls")])


def _read_counts(counters) -> List[int]:
    return [getattr(owner, name) for owner, name in counters]


def _add_counts(counters, counts: Sequence[int], sign: int = 1) -> None:
    for (owner, name), n in zip(counters, counts):
        setattr(owner, name, getattr(owner, name) + sign * n)


class _Snapshot:
    """What a step changes, to undo a warm-up step: the parameters, Adam's
    state, the generators, ``state.step`` and the launch counts."""

    def __init__(self, state: TrainState, generators, counters):
        self.state, self.generators, self.counters = state, generators, counters
        opt = state.optimizer
        self.params = [p for group in opt.param_groups for p in group["params"]]
        with torch.no_grad():
            self.values = [p.detach().clone() for p in self.params]
        self.moments = {p: {k: v.clone() for k, v in opt.state[p].items()}
                        for p in self.params if opt.state.get(p)}
        self.gen_states = [g.get_state() for g in generators]
        self.step = state.step
        self.counts = _read_counts(counters)

    def restore(self) -> None:
        opt = self.state.optimizer
        with torch.no_grad():
            for p, v in zip(self.params, self.values):
                p.copy_(v)
                p.grad = None
            for p in self.params:
                # a state the warm-up made is a fresh one's: zeros (Adam's
                # first step then sees what it would have made itself)
                held = self.moments.get(p)
                for k, v in opt.state.get(p, {}).items():
                    if held:
                        v.copy_(held[k])
                    else:
                        v.zero_()
        for g, st in zip(self.generators, self.gen_states):
            g.set_state(st)
        self.state.step = self.step
        _add_counts(self.counters, [a - b for a, b in
                                    zip(_read_counts(self.counters), self.counts)], -1)


class ChunkRunner:
    """Chunks of ``k`` steps of ``step_fn`` on ``state`` (see the module
    docstring). ``step_fn(state, rays_o, rays_d, near, far, target, lr=)``
    is the step with its draws bound (``functools.partial``);
    ``generators``: every generator a chunk draws on, the step's and the
    sampler's (registered with each graph and restored after the warm-up
    step; the sampler's only where its draws are in the chunk);
    ``lr_table[t]``: the learning rate of update ``base + t``, float32 on
    the device; ``near`` / ``far``: the batch's bounds."""

    def __init__(self, step_fn, state: TrainState, k: int, near: torch.Tensor, far: torch.Tensor,
                 generators: Sequence[torch.Generator], lr_table: torch.Tensor, base: int):
        self.step_fn, self.state, self.k = step_fn, state, k
        self.near, self.far = near, far
        self.generators = list(generators)
        self.lr_table, self.base = lr_table, base
        self.device = lr_table.device
        self.graphs: Dict[str, tuple] = {}
        self.pool = None
        self.replays = 0
        self.lrs = torch.empty(k, dtype=torch.float32, device=self.device)
        self.window = None

    def _steps(self, sample: Sample, window, n: int) -> Dict[str, torch.Tensor]:
        auxes = []
        for j in range(n):
            ro, rd, target = sample(j, window)
            auxes.append(self.step_fn(self.state, ro, rd, self.near, self.far, target,
                                      lr=self.lrs[j]))
        return {name: torch.stack([a[name] for a in auxes]) for name in auxes[0]}

    def _inputs(self, window) -> None:
        t0 = self.state.step - self.base
        self.lrs.copy_(self.lr_table[t0 : t0 + self.k])
        if window is not None:
            if self.window is None:
                self.window = torch.empty_like(window)
            self.window.copy_(window)

    def run(self, phase: str, sample: Sample, window=None) -> Dict[str, torch.Tensor]:
        """The k steps from ``state.step``, ``phase`` naming the graph;
        each aux value stacked over them [k]."""
        self._inputs(window)
        if self.device.type != "cuda":
            return self._steps(sample, self.window, self.k)
        if phase not in self.graphs:
            self.graphs[phase] = self._capture(sample)
        graph, outputs, counts = self.graphs[phase]
        graph.replay()
        self.replays += 1
        _add_counts(self._counters, counts)
        # a replay's in-place updates pass autograd's version counters by:
        # bump them, so that what keys on them (fused_mlp.packed_params'
        # packing for serving) sees the new weights
        for group in self.state.optimizer.param_groups:
            for p in group["params"]:
                torch.autograd.graph.increment_version(p)
        self.state.step += self.k
        return {name: t.clone() for name, t in outputs.items()}

    def _capture(self, sample: Sample):
        self._counters = launch_counters()
        snap = _Snapshot(self.state, self.generators, self._counters)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._steps(sample, self.window, 1)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        snap.restore()
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = _read_counts(self._counters)
        # "thread_local": a call this thread may not make while capturing
        # still raises, but another thread's CUDA call is no error of the
        # capture's. Over NCCL ranks one such thread runs throughout, NCCL's
        # watchdog, which queries its collectives' events, and a "global"
        # capture forbids such queries to every thread of the process. On
        # H100s, groups of 1, 2 and 4 NCCL ranks captured and replayed bit
        # for bit in either mode (PERF.md §6).
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            outputs = self._steps(sample, self.window, self.k)
        self.pool = graph.pool()
        counts = [a - b for a, b in zip(_read_counts(self._counters), before)]
        _add_counts(self._counters, counts, -1)  # the capture launched nothing
        self.state.step -= self.k
        return graph, outputs, counts
