"""Phase 1 of the fused MLP backward on the card, the two bf16 launches in
``csrc/fused_mlp_bwd.cu`` that K4, K3 and K6 all make: the recompute
(``bwd_recompute_sm90``, K1's tile writing the activations' workspace rows
and relu mask words) and the cotangent chain (``bwd_chain_sm90``, on that
tile's TMA ring and wgmma warpgroups, reading the mask words). Its outputs, to show that two builds give bit-identical grads,
and its time by launch at the training shapes.

    python -m nerf_tpu_torch.tools.bwd_phase1 save OUT.pt
    python -m nerf_tpu_torch.tools.bwd_phase1 compare A.pt B.pt
    python -m nerf_tpu_torch.tools.bwd_phase1 time

``save`` runs K4, K3 (with and without input grads) and K6 in bf16 on fixed
seeded inputs (``CASES``: the training shapes, a point count that is not a
multiple of 128, a direction per point, W=128) and writes every output to
OUT.pt, with the K6 cases' forward: K5's maps and raw; and the raw of the
bf16 forwards K1 and K2 on such inputs. ``compare`` holds two such files to
each other with ``torch.equal``, prints every tensor that differs and exits
1 if any does. A K6 case holds K5's outputs and runs K6 on K5's raw, so
where K5's bf16 kernel differs between the two builds (its sums' order, as
between the mma.sync tile and the wgmma one) the K6 cases differ too,
with no fault in the backward; the summary lists them apart from the other
cases. ``time`` profiles ``REPS`` K4 training
steps (a coarse launch at S=64 and a fine one at S=192, N_rand=4096) after
``WARMUP`` with ``k4_split``, the split that chip_smoke.py's phase 9 prints,
and times a training step of K4, K3 (63 + 191 samples, a direction per
ray) and K6 (64 + 192, from K5's raw) and of their stacked forms (8 scenes
of 1,024 rays) by CUDA events, the mean of ``REPS`` steps after
``WARMUP``; it prints the device ms a step of each of K4's launches and
the steps' ms as one JSON line.

The tool imports only ``nerf_tpu_torch``. Run as a file with another
checkout's root on ``PYTHONPATH`` it drives that checkout's kernels:

    PYTHONPATH=/path/to/other python nerf_tpu_torch/tools/bwd_phase1.py save other.pt
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Dict, Sequence

import numpy as np
import torch

from nerf_tpu_torch.experimental import fused_render
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import fused_mlp
from nerf_tpu_torch.utils.profiler import launch_split

PE_P, PE_V = PosEncConfig(10), PosEncConfig(4)
N_RAND = 4096
TRAIN_S = (64, 192)  # the training step's two levels at 64+128
# (kernel, width, R, S, spr, input_grads); spr is S for K4 and K6
CASES = (
    ("K4", 256, N_RAND, 64, 64, False),
    ("K4", 256, N_RAND, 192, 192, False),
    ("K4", 256, 301, 64, 64, False),  # 19,264 points: a part tile
    ("K4", 128, 301, 64, 64, False),
    ("K3", 256, N_RAND, 63, 63, False),  # the 63+128 training step
    ("K3", 256, N_RAND, 191, 191, False),
    ("K3", 256, 150, 63, 1, False),  # a direction per point
    ("K3", 256, 150, 63, 1, True),
    ("K3", 256, 77, 48, 48, True),
    ("K3", 128, 150, 63, 1, True),
    ("K3", 128, 77, 48, 48, False),
    ("K6", 256, N_RAND, 64, 64, False),
    ("K6", 256, N_RAND, 192, 192, False),
    ("K6", 256, 1000, 200, 200, False),
    ("K6", 128, 1000, 64, 64, False),
    ("K1", 256, N_RAND, 64, 64, False),  # the forwards (the tile K5 shares)
    ("K1", 256, N_RAND, 192, 192, False),
    ("K1", 128, 301, 64, 64, False),
    ("K2", 256, N_RAND, 63, 1, False),
)
# K4's launches by kernel name, in order after its partials' clear
# ("Memset"): phase 1's recompute and chain, phase 2, phase 3 and its sums
K4_LAUNCHES = ("bwd_recompute_sm90", "bwd_chain_sm90", "ray_prep", "wgrad_bf16", "reduce_splits",
               "reduce_tiles", "Memset")
WARMUP, REPS = 3, 10


def _rays(seed: int, R: int, S: int, dev):
    """Rays from a radius-4 sphere towards the origin, depths in [2, 6]."""
    rng = np.random.default_rng(seed)
    ro = rng.standard_normal((R, 3)).astype(np.float32)
    ro = 4.0 * ro / np.linalg.norm(ro, axis=-1, keepdims=True)
    rd = (-ro / 4.0 + 0.3 * rng.standard_normal((R, 3))).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)).astype(np.float32), -1)
    g = (0.5 + rng.random((4, R, S), dtype=np.float32)) * 1e-4  # one-signed, as a loss's
    return [torch.from_numpy(a).to(dev) for a in (ro, rd, vd, z, g)]


def _packed(width: int, dev):
    mlp = NeRFMLP(MLPConfig(width=width), seed=width, device=dev)
    with torch.no_grad():
        return fused_mlp.pack_params(mlp, PE_P, PE_V, torch.bfloat16)


def run_case(case, dev) -> Dict[str, torch.Tensor]:
    """The case's outputs (grads by leaf name, dx, dv), on the CPU."""
    kernel, width, R, S, spr, input_grads = case
    kp = _packed(width, dev)
    ro, rd, vd, z, g = _rays(R * S + width, R, S, dev)
    if kernel == "K1":
        out = {"raw": fused_mlp.fused_rays_planes(kp, ro, rd, vd, z)}
    elif kernel == "K2":
        x = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(R * S, 3)
        out = {"raw": fused_mlp.fused_points(kp, x, vd.repeat_interleave(S, 0), spr)}
    elif kernel == "K4":
        out = fused_mlp.fused_rays_planes_bwd(kp, ro, rd, vd, z, g)
    elif kernel == "K3":
        x = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(R * S, 3)
        v = vd if spr > 1 else vd.repeat_interleave(S, 0)
        grads, dx, dv = fused_mlp.fused_points_bwd(kp, x, v, g.reshape(4, -1).T.contiguous(), spr,
                                                   input_grads)
        out = dict(grads, **({"dx": dx, "dv": dv} if input_grads else {}))
    else:
        noise = torch.from_numpy(
            np.random.default_rng(R + S).standard_normal((R, S)).astype(np.float32) * 0.5).to(dev)
        white = S >= 192
        fwd = fused_render.fused_render_fwd(kp, ro, rd, vd, z, noise, white, keep_raw=True)
        maps = (g[:3, :, 0].T.contiguous(), g[3, :, 0].contiguous(), g[3, :, 1].contiguous(),
                g[0].contiguous())
        out = fused_render.fused_render_bwd(kp, ro, rd, vd, z, noise, fwd.raw, *maps, white)
        out.update({f"K5.{k}": t for k, t in zip(("rgb", "disp", "acc", "w", "raw"), fwd)})
    torch.cuda.synchronize()
    return {k: t.cpu() for k, t in out.items()}


def save(path: str) -> None:
    dev = torch.device("cuda")
    results = {"-".join(map(str, case)): run_case(case, dev) for case in CASES}
    torch.save(results, path)
    print(json.dumps({"saved": path, "cases": len(results),
                      "tensors": sum(len(v) for v in results.values())}))


def compare(a: str, b: str) -> int:
    A, B = torch.load(a), torch.load(b)
    if sorted(A) != sorted(B):
        print(f"case lists differ: {sorted(set(A) ^ set(B))}")
        return 1
    n, differ = 0, {}  # case -> names of the tensors that differ
    for case in A:
        if sorted(A[case]) != sorted(B[case]):
            print(f"{case}: outputs differ: {sorted(set(A[case]) ^ set(B[case]))}")
            return 1
        for name, t in A[case].items():
            n += 1
            if not torch.equal(t, B[case][name]):
                d = float((t - B[case][name]).abs().max())
                scale = float(B[case][name].abs().max())
                print(f"{case} {name}: not bit-identical (max abs {d:.3e}, "
                      f"{d / max(scale, 1e-30):.3e} of its largest magnitude)")
                differ.setdefault(case, []).append(name)
    # K6's cases hold K5's outputs and run K6 on K5's raw: they differ
    # wherever the two builds' K5 differ
    k6 = sorted(c for c in differ if c.startswith("K6"))
    names = sorted({name for names in differ.values() for name in names})
    print(json.dumps({"bit_identical": not differ, "cases": len(A), "tensors": n,
                      "tensors_differing": sum(len(v) for v in differ.values()),
                      "names_differing": names, "k6_cases_differing": k6,
                      "other_cases_differing": sorted(c for c in differ if c not in k6)}))
    return 1 if differ else 0


def k4_split(kp, blobs, step: Sequence, reps: int, warmup: int = 1) -> Dict[str, float]:
    """Device ms of a K4 training step by launch (``K4_LAUNCHES``, the rest
    as "other"): ``step`` holds each level's (ro, rd, vd, z, g)."""
    def k4_step():
        for ro, rd, vd, z, g in step:
            fused_mlp.fused_rays_planes_bwd(kp, ro, rd, vd, z, g, blobs)

    return launch_split(k4_step, K4_LAUNCHES, reps=reps, warmup=warmup)


def _event_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """ms a call of fn by CUDA events: the mean of reps calls after warmup."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


STACKED_SCENES, STACKED_RAYS = 8, 1024


def step_times(dev) -> Dict[str, float]:
    """ms a training step of K4, K3 and K6 (N_rand 4096, both levels) and of
    the stacked K4s, K3s and K6s (STACKED_SCENES x STACKED_RAYS rays)."""
    kp = _packed(256, dev)
    blobs = fused_mlp.kernel_blobs(kp)
    kps = [_packed(256, dev) for _ in range(STACKED_SCENES)]
    skp = {k: torch.stack([q[k] for q in kps]) for k in kp}
    sblobs = fused_mlp.kernel_blobs(skp)

    def levels(samples, R, scenes=None):
        out = []
        for S in samples:
            ro, rd, vd, z, g = _rays(S, R * (scenes or 1), S, dev)
            if scenes:
                ro, rd, vd = (t.reshape(scenes, R, 3) for t in (ro, rd, vd))
                z, g = z.reshape(scenes, R, S), g.reshape(4, scenes, R, S)
            out.append((ro, rd, vd, z, g))
        return out

    def points(ro, rd, z, lead):
        return (ro[..., None, :] + rd[..., None, :] * z[..., None]).reshape(*lead, 3)

    def render_inputs(lv, stacked):
        fwd = fused_render.fused_render_stacked_fwd if stacked else fused_render.fused_render_fwd
        out = []
        for ro, rd, vd, z, g in lv:
            noise = torch.zeros_like(z)
            raw = fwd(kp if not stacked else skp, ro, rd, vd, z, noise, True,
                      blobs if not stacked else sblobs, keep_raw=True).raw
            maps = (g[:3, ..., 0].movedim(0, -1).contiguous(), g[3, ..., 0].contiguous(),
                    g[3, ..., 1].contiguous(), g[0].contiguous())
            out.append((ro, rd, vd, z, noise, raw, maps))
        return out

    train, stacked = levels(TRAIN_S, N_RAND), levels(TRAIN_S, STACKED_RAYS, STACKED_SCENES)
    train63, stacked63 = levels((63, 191), N_RAND), levels((63, 191), STACKED_RAYS, STACKED_SCENES)
    k3 = [(points(ro, rd, z, (-1,)), vd, g.reshape(4, -1).T.contiguous(), z.shape[-1])
          for ro, rd, vd, z, g in train63]
    k3s = [(points(ro, rd, z, (STACKED_SCENES, -1)), vd,
            g.reshape(4, STACKED_SCENES, -1).permute(1, 2, 0).contiguous(), z.shape[-1])
           for ro, rd, vd, z, g in stacked63]
    k6, k6s = render_inputs(train, False), render_inputs(stacked, True)
    return {
        "K4": _event_ms(lambda: [fused_mlp.fused_rays_planes_bwd(kp, *lv, blobs) for lv in train]),
        "K3": _event_ms(lambda: [fused_mlp.fused_points_bwd(kp, x, v, g, s, False, blobs)
                                 for x, v, g, s in k3]),
        "K6": _event_ms(lambda: [fused_render.fused_render_bwd(kp, *a[:6], *a[6], True, blobs)
                                 for a in k6]),
        "K4s": _event_ms(lambda: [fused_mlp.fused_rays_planes_stacked_bwd(skp, *lv, sblobs)
                                  for lv in stacked]),
        "K3s": _event_ms(lambda: [fused_mlp.fused_points_stacked_bwd(skp, x, v, g, s, sblobs)
                                  for x, v, g, s in k3s]),
        "K6s": _event_ms(lambda: [fused_render.fused_render_stacked_bwd(skp, *a[:6], *a[6], True,
                                                                        sblobs) for a in k6s]),
    }


def time_step() -> None:
    """Device ms a K4 training step (S=64 + S=192) by launch, and the step
    times of ``step_times``."""
    dev = torch.device("cuda")
    kp = _packed(256, dev)
    step = [_rays(S, N_RAND, S, dev) for S in TRAIN_S]
    split = k4_split(kp, fused_mlp.kernel_blobs(kp), step, REPS, WARMUP)
    del step
    steps = step_times(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "steps": REPS, **{f"{k}_ms": round(v, 3) for k, v in split.items()},
                      "device_ms": round(sum(split.values()), 3),
                      **{f"{k}_step_ms": round(v, 3) for k, v in steps.items()}}))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("bwd_phase1: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["save"] and len(argv) == 2:
        save(argv[1])
        return 0
    if argv[:1] == ["compare"] and len(argv) == 3:
        return compare(argv[1], argv[2])
    if argv == ["time"]:
        time_step()
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
