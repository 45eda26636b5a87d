"""Train-step throughput and an analytic MFU.

Counterpart of nerf_tpu/utils/profiler.py's ``StepTimer``. The FLOP per
point come from ``ops/fused_mlp.py::flops_per_point`` (nerf_tpu's
``mlp_flops_per_point`` counts one trunk layer too few); forward plus
backward is counted as 3x the forward, nerf_tpu's convention. The peak is
the card's dense bf16 rate, looked up from its name; a run on the CPU or on
an unknown card reports no MFU.
"""

from __future__ import annotations

from typing import Optional

import torch

# dense bf16 tensor-core FLOP/s by card name (NVIDIA's data sheets, SXM parts)
PEAK_BF16_FLOPS = {"h100": 989e12, "h200": 989e12}


def device_peak_flops(device) -> Optional[float]:
    """The card's dense bf16 peak, or None off the card / for an unknown card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in PEAK_BF16_FLOPS.items():
        if key in name:
            return peak
    return None


class StepTimer:
    """Train-step throughput with an analytic MFU estimate."""

    def __init__(self, rays_per_step: int, points_per_ray: int, flops_per_point: int,
                 peak: Optional[float] = None):
        self.rays_per_step = rays_per_step
        self.points_per_step = rays_per_step * points_per_ray
        self.flops_per_point = flops_per_point
        self.peak = peak

    def report(self, steps: int, elapsed: float) -> dict:
        """Throughput of ``steps`` steps that took ``elapsed`` seconds (a
        window that ends in a device sync). ``mfu`` is None when the peak is
        unknown."""
        sps = steps / max(elapsed, 1e-12)
        flops = 3 * self.points_per_step * self.flops_per_point * sps
        return {
            "steps_per_sec": sps,
            "rays_per_sec": sps * self.rays_per_step,
            "point_evals_per_sec": sps * self.points_per_step,
            "model_tflops": flops / 1e12,
            "mfu": None if self.peak is None else flops / self.peak,
        }
