"""Train CLI, the reference's entry point (run_nerf.py:875-878).

Counterpart of nerf_tpu/cli/train.py, on one card:

    python -m nerf_tpu_torch.cli.train --config configs/lego.txt [--flag value ...]

with the reference's flag set (nerf_tpu_torch/config.py). nerf_tpu's
multi-host bring-up (``distributed.initialize``, ROADMAP A.8) and its JAX
compile cache have no counterpart here.
"""

from __future__ import annotations

import sys

from nerf_tpu_torch.config import load_config
from nerf_tpu_torch.device import DeviceLike
from nerf_tpu_torch.train.loop import TrainResult, train


def main(argv=None, device: DeviceLike = None) -> TrainResult:
    """Parse ``argv`` and train on ``device`` (the card unless told otherwise)."""
    return train(load_config(argv), device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
