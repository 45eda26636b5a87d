"""Render-only CLI (the reference's --render_only path, run_nerf.py:654-672).

Counterpart of nerf_tpu/cli/render.py:

    python -m nerf_tpu_torch.cli.render --config configs/lego.txt [--render_test]

loads the experiment's newest ``.tar`` checkpoint and renders the pose path
(or the test set, with PSNRs) to PNGs and a video.
"""

from __future__ import annotations

import dataclasses
import sys

from nerf_tpu_torch.config import load_config
from nerf_tpu_torch.device import DeviceLike
from nerf_tpu_torch.train.loop import TrainResult, train


def main(argv=None, device: DeviceLike = None) -> TrainResult:
    """Parse ``argv`` and render on ``device`` (the card unless told otherwise)."""
    return train(dataclasses.replace(load_config(argv), render_only=True), device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
