"""Profiler capture, train-step throughput and an analytic MFU.

Counterpart of nerf_tpu/utils/profiler.py. ``trace`` captures a block with
``torch.profiler`` (CPU and CUDA activities: host ops and the card's
kernels) and writes a Chrome trace, where nerf_tpu writes an XProf one.
``StepTimer`` is its ``StepTimer``. ``device_rows`` and ``launch_split``
read a profile's card time by kernel. The FLOP per
point come from ``ops/fused_mlp.py::flops_per_point`` (nerf_tpu's
``mlp_flops_per_point`` counts one trunk layer too few); forward plus
backward is counted as 3x the forward, nerf_tpu's convention. The peak is
the card's dense bf16 rate, looked up from its name; a run on the CPU or on
an unknown card reports no MFU.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

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


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write ``logdir/trace.json`` (Chrome trace
    format; chrome://tracing or Perfetto): ``with trace(d): step(...)``.
    CUDA activity is recorded where a card is present; the caller
    synchronises inside the block so the card's work falls in it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_rows(prof, annotations: bool = False) -> List[Tuple[float, str, int]]:
    """(device us, kernel name, count) of every device activity in a profile:
    kernels, copies and sets. A ``record_function`` range also appears on
    the device, as a user annotation that spans the kernels it launched
    (the optimizer's ``Optimizer.step#Adam.step``); those kernels have rows
    of their own, so annotations are left out unless ``annotations`` asks
    for them alone."""
    rows = []
    for evt in prof.key_averages():
        if bool(getattr(evt, "is_user_annotation", False)) != annotations:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, evt.key, evt.count))
    return rows


def launch_split(fn: Callable[[], None], names: Iterable[str], reps: int = 3,
                 warmup: int = 1) -> Dict[str, float]:
    """Device ms per call of ``fn`` by kernel: the kernels whose names hold
    one of ``names``, and the rest as "other", from a torch.profiler window
    over ``reps`` calls after ``warmup`` calls."""
    names = list(names)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {k: 0.0 for k in names + ["other"]}
    for us, key, _ in device_rows(prof):
        split[next((k for k in names if k in key), "other")] += us / 1e3 / reps
    return split


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
