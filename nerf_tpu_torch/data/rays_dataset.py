"""Per-step ray-batch selection: the reference's two policies, on the device.

Counterpart of nerf_tpu/data/rays_dataset.py:

(a) ``use_batching`` (ref run_nerf.py:676-698, 715-726): the rays of all
    train images as one [N_total, 3, 3] buffer (origin, direction, rgb),
    uploaded once; a device permutation per epoch, consumed in N_rand
    windows.
(b) ``no_batching`` (ref run_nerf.py:728-757): one random train image per
    step, its rays generated on the device, N_rand pixels drawn without
    replacement, from a center crop for the first ``precrop_iters`` steps.

Randomness comes from one ``torch.Generator`` on the sampler's device, so a
step's batch never waits for the host. With a ``mesh`` (data parallelism,
parallel/mesh.py) every rank seeds the same generator and draws the same
global window, then keeps its own rows (``mesh.shard_slice``), as
nerf_tpu's per-host feed does (its ``_host_sl``, rays_dataset.py:74-99,
279-340): the ranks' rows, put together, are the one-process batch.

The fused loop (train/loop.py, ``fuse_steps``; nerf_tpu's lax.scan of k
steps, rays_dataset.py:123-222, 342-436) takes k steps' batches as one
chunk: ``scan_supported``, ``max_chunk`` and ``advance(k)`` on both
policies; the batching policy's ``window(k)`` (nerf_tpu's ``_window``) gives
the chunk's [k, n_rand] indices, the input of the chunk's CUDA graph
(train/graph.py), and ``gather`` a step's batch from its row. The image
policy draws inside the chunk on its own generator, as k ``next_batch``
calls would, its crop fixed for the chunk.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nerf_tpu_torch.data.scene import Scene
from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.geom.rays import get_rays, get_rays_np

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def build_ray_buffer(scene: Scene) -> np.ndarray:
    """Host-side precompute of [N_train*H*W, 3, 3] (ro, rd, rgb) float32
    (ref run_nerf.py:680-686)."""
    rays = np.stack(
        [get_rays_np(scene.H, scene.W, scene.K, p[:3, :4]) for p in scene.poses], 0
    )  # [N, 2, H, W, 3]
    rays_rgb = np.concatenate([rays, scene.images[:, None]], 1)  # [N, 3, H, W, 3]
    rays_rgb = np.transpose(rays_rgb, [0, 2, 3, 1, 4])  # [N, H, W, 3, 3]
    rays_rgb = np.stack([rays_rgb[i] for i in scene.i_train], 0)
    return np.reshape(rays_rgb, [-1, 3, 3]).astype(np.float32)


class BatchedRaySampler:
    """Policy (a): an epoch-shuffled window over the ray buffer."""

    def __init__(self, scene: Scene, n_rand: int, generator: torch.Generator,
                 device: DeviceLike = None, mesh=None):
        self.n_rand = n_rand
        self.rows = slice(0, n_rand) if mesh is None else mesh.shard_slice(n_rand)
        self.device = resolve_device(device)
        self.buffer = torch.as_tensor(build_ray_buffer(scene), device=self.device)
        self.n_total = self.buffer.shape[0]
        self.generator = generator
        self.perm = None
        self.i_batch = 0
        self._reshuffle()

    def _reshuffle(self):
        self.perm = torch.randperm(self.n_total, generator=self.generator, device=self.device)
        self.i_batch = 0

    def ensure_epoch(self):
        """Wrap the permutation when fewer than n_rand rays remain (epoch
        boundary, ref run_nerf.py:722-726): the window takes the old
        permutation's tail and the new one's head, so every ray is used
        exactly once per epoch and every batch has n_rand rays."""
        if self.i_batch + self.n_rand > self.perm.shape[0]:
            tail = self.perm[self.i_batch :]
            self._reshuffle()
            self.perm = torch.cat([tail, self.perm])

    def next_batch(self) -> Batch:
        self.ensure_epoch()
        window = self.perm[self.i_batch : self.i_batch + self.n_rand]
        self.i_batch += self.n_rand
        return self.gather(window)

    def gather(self, idx: torch.Tensor) -> Batch:
        """A step's (rays_o, rays_d, target) from its n_rand indices into the
        buffer (this rank's rows of them)."""
        batch = self.buffer[idx[self.rows]]
        return batch[:, 0], batch[:, 1], batch[:, 2]

    # --- the fused loop (train/loop.py fuse_steps) ---

    def scan_supported(self) -> bool:
        return True

    def max_chunk(self) -> int:
        """A window spans epoch wraps itself, so chunks need no cap."""
        return 1 << 30

    def window(self, k: int) -> torch.Tensor:
        """The next k steps' indices [k, n_rand], crossing epoch wraps
        exactly as k ``next_batch`` calls would (``ensure_epoch``'s tail,
        then a new permutation from the generator, in the same order). The
        state it reaches (the permutation, the offset, the generator's)
        is staged; ``advance(k)`` commits it."""
        perm, i_batch = self.perm, self.i_batch
        before = self.generator.get_state()
        out, need = [], k
        while need:
            take = min(need, (perm.shape[0] - i_batch) // self.n_rand)
            if take:
                out.append(perm[i_batch : i_batch + take * self.n_rand])
                i_batch += take * self.n_rand
                need -= take
            if need:
                tail = perm[i_batch:]
                perm = torch.cat([tail, torch.randperm(self.n_total, generator=self.generator,
                                                       device=self.device)])
                i_batch = 0
        self._staged = (perm, i_batch, self.generator.get_state())
        self.generator.set_state(before)
        return (out[0] if len(out) == 1 else torch.cat(out)).view(k, self.n_rand)

    def advance(self, k: int) -> None:
        """Commit the state ``window(k)`` staged."""
        self.perm, self.i_batch, after = self._staged
        self.generator.set_state(after)


class ImageRaySampler:
    """Policy (b): one train image per step, N_rand of its pixels, from the
    center crop while ``step < precrop_iters``."""

    def __init__(self, scene: Scene, n_rand: int, generator: torch.Generator,
                 precrop_iters: int = 0, precrop_frac: float = 0.5,
                 device: DeviceLike = None, mesh=None):
        self.H, self.W = scene.H, scene.W
        self.n_rand = n_rand
        self.rows = slice(0, n_rand) if mesh is None else mesh.shard_slice(n_rand)
        self.precrop_iters = precrop_iters
        self.device = resolve_device(device)
        self.images = torch.as_tensor(np.asarray(scene.images, np.float32), device=self.device)
        self.poses = torch.as_tensor(np.asarray(scene.poses, np.float32), device=self.device)
        self.i_train = torch.as_tensor(np.asarray(scene.i_train), device=self.device)
        self.K = np.asarray(scene.K, np.float32)
        self.generator = generator
        dH = int(self.H // 2 * precrop_frac)
        dW = int(self.W // 2 * precrop_frac)
        # crop bounds per ref run_nerf.py:738-745: rows in [H//2-dH, H//2+dH)
        self.crop = (self.H // 2 - dH, self.W // 2 - dW, 2 * dH, 2 * dW)
        self.full = (0, 0, self.H, self.W)

    def next_batch(self, step: int) -> Batch:
        gen, dev = self.generator, self.device
        pick = torch.randint(self.i_train.shape[0], (1,), generator=gen, device=dev)
        # index_select, not a 0-dim index: that would read the index on the
        # host, a sync a step (and no op a CUDA graph may capture)
        img_i = self.i_train[pick]
        c2w = self.poses.index_select(0, img_i)[0, :3, :4]
        rays_o, rays_d = get_rays(self.H, self.W, self.K, c2w)
        row0, col0, rows, cols = self.crop if step < self.precrop_iters else self.full
        n = rows * cols
        if self.n_rand > n:
            # fewer pixels than N_rand: draw with replacement (the reference
            # would fail there)
            flat = torch.randint(n, (self.n_rand,), generator=gen, device=dev)
        else:
            flat = torch.randperm(n, generator=gen, device=dev)[: self.n_rand]
        flat = flat[self.rows]
        r = row0 + flat // cols
        c = col0 + flat % cols
        return rays_o[r, c], rays_d[r, c], self.images.index_select(0, img_i)[0][r, c]

    # --- the fused loop (train/loop.py fuse_steps): a chunk's k steps call
    # next_batch with the chunk's crop (the loop never lets a chunk cross
    # the precrop boundary), drawing on the generator as k calls would ---

    def scan_supported(self) -> bool:
        return True

    def max_chunk(self) -> int:
        return 1 << 30  # no epoch state; the loop bounds chunks elsewhere

    def advance(self, k: int) -> None:
        """Nothing to commit: the chunk's draws moved the generator."""


def make_sampler(scene: Scene, cfg, generator: torch.Generator, device: DeviceLike = None,
                 mesh=None):
    """The policy the config names (ref use_batching = not no_batching); with
    a ``mesh``, this rank's rows of each batch."""
    if cfg.no_batching:
        return ImageRaySampler(
            scene, cfg.N_rand, generator, cfg.precrop_iters, cfg.precrop_frac, device=device,
            mesh=mesh,
        )
    return BatchedRaySampler(scene, cfg.N_rand, generator, device=device, mesh=mesh)
