"""Train CLI, the reference's entry point (run_nerf.py:875-878).

Counterpart of nerf_tpu/cli/train.py:

    python -m nerf_tpu_torch.cli.train --config configs/lego.txt [--flag value ...]

with the reference's flag set (nerf_tpu_torch/config.py). ``--data_axis``
says over how many cards to train, a process (rank) each: 0, the default,
means every visible card, k means k of them. Started alone, the CLI
launches the ranks itself (``parallel.distributed.launch``); under torchrun,
or with the config's ``coordinator_address``/``num_processes``/
``process_id``, it joins that group instead (``distributed.initialize``),
nerf_tpu's multi-host bring-up. On the CPU (``main(..., device="cpu")``)
``--data_axis k`` runs k gloo ranks. nerf_tpu's JAX compile cache has no
counterpart here.
"""

from __future__ import annotations

import sys

import torch

from nerf_tpu_torch.config import NeRFConfig, load_config
from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.parallel import distributed
from nerf_tpu_torch.train.loop import TrainResult, train


def data_ranks(cfg: NeRFConfig, device: DeviceLike = None) -> int:
    """The ranks ``cfg.data_axis`` asks for on ``device``: on the card 0 is
    every visible card and more than the visible cards raises; on the CPU
    0 is one rank."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return max(cfg.data_axis, 1)
    visible = torch.cuda.device_count()
    n = cfg.data_axis if cfg.data_axis > 0 else visible
    if n > visible:
        raise ValueError(f"data_axis={cfg.data_axis} but {visible} cards are visible")
    if n > 1 and dev.index is not None:
        raise ValueError(f"{n} ranks need a card each: pass device='cuda', not {dev}")
    return n


def prebuild(cfg: NeRFConfig, device: DeviceLike = None) -> None:
    """Build the libraries the ranks will load, once, before they start (n
    ranks would otherwise each run the same compilers at once)."""
    from nerf_tpu_torch.native import resize
    from nerf_tpu_torch.ops import _build

    if resolve_device(device).type == "cuda" and cfg.fused_kernels:
        _build.load_all(["fused_mlp_fwd", "fused_mlp_bwd"]
                        + (["fused_render"] if cfg.fused_render else []))
    if cfg.dataset_type == "llff":
        resize.build()


def _train_rank(device, cfg: NeRFConfig) -> TrainResult:
    return train(cfg, device=device)


def run(cfg: NeRFConfig, device: DeviceLike = None):
    """Train (or render, with ``cfg.render_only``) as the config says: in the
    process group this process is started in, else over ``data_ranks``
    ranks that it launches. Returns the TrainResult, or with launched ranks
    a list of theirs, rank 0 first, on the CPU."""
    if distributed.initialize(cfg.coordinator_address, cfg.num_processes, cfg.process_id,
                              device=device):
        return train(cfg, device=device)
    n = data_ranks(cfg, device)
    if n == 1:
        return train(cfg, device=device)
    prebuild(cfg, device)
    return distributed.launch(_train_rank, n, device, args=(cfg,))


def main(argv=None, device: DeviceLike = None):
    """Parse ``argv`` and train on ``device`` (the card unless told otherwise)."""
    return run(load_config(argv), device)


if __name__ == "__main__":
    main(sys.argv[1:])
