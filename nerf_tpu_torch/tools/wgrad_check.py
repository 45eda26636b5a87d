"""The backward's weight-grad launch alone on the card: ``wgrad_bf16``
(csrc/wgrad_sm90.cuh, phase 3 of K4, K3 and K6 and of the wide family's
K4w, K3w and K6w) through ``fused_mlp_wide.Ops.wgrad``, on seeded random bf16
workspace rows with the problem list and splits the backward gives them.

    python -m nerf_tpu_torch.tools.wgrad_check check [OUT.pt]
    python -m nerf_tpu_torch.tools.wgrad_check compare A.pt B.pt
    python -m nerf_tpu_torch.tools.wgrad_check time

``check`` runs each of ``CASES`` (the main path's 1,048,576 points at W =
256, W = 512 and 1024 dense and a direction per ray, 8 stacked scenes at W
= 256 and 512): two launches, which must be bit-identical, and the plain
version (``PlainOps.wgrad``: each product in f32), which the launch must
match within ``REL_L2`` relative L2 in every weight grad; prints a line a
case with the launch's cluster size and grid and both sides' distance
from the products summed in f64, and writes the outputs to OUT.pt.
``compare`` holds two such files to each other with ``torch.equal`` (exit
1 where any case differs). ``time`` prints one JSON
line: at the training step's shapes (N_rand 4096 rays at 64 and at 192
samples, a direction per ray) for W = 256 and 512, the ms of the two
launches beside their bound (each row read once and the grads written
once at 3.35 TB/s, or the products at 989 TFLOP/s) and the same products
as bf16 ``torch.matmul`` on the same workspace rows.

The tool imports only ``nerf_tpu_torch``; run as a file with another
checkout's root on ``PYTHONPATH`` it drives that checkout's kernel (its own
problem list and splits), so two builds compare in one call:

    PYTHONPATH=/path/to/other python nerf_tpu_torch/tools/wgrad_check.py check other.pt
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from typing import Dict

import torch

from nerf_tpu_torch.ops import _build, fused_mlp
from nerf_tpu_torch.ops import fused_mlp_wide as wide

# The kernel's f32 wgmma sums run serially over a split's up to 16,384
# points: on these zero-mean rows 1.7-1.9e-5 from the f64 sums of the same
# products, as for the same kernel without clusters (cuBLAS's f32 sums
# 6e-7-3.5e-6 from them; NVIDIA H100 80GB HBM3, PERF.md §6). The bound is
# twice that: a lost 64-point chunk moves a grad by ~1e-2, a misplaced box
# by ~1.
REL_L2 = 4e-5
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 989e12  # H100 SXM, dense bf16
N_RAND, LEVELS = 4096, (64, 192)
# name: (W, points a scene, points a view direction (1: one a point), scenes)
CASES = {
    "main_s64": (256, N_RAND * 64, 64, 1),
    "main_s192": (256, N_RAND * 192, 192, 1),
    "w512_dense": (512, 1 << 20, 1, 1),
    "w512_rays": (512, 1 << 20, 256, 1),
    "w1024_dense": (1024, 1 << 18, 1, 1),
    "w1024_rays": (1024, 1 << 18, 64, 1),
    "stacked8_w256": (256, 1 << 18, 256, 8),
    "stacked8_w512": (512, 1 << 17, 128, 8),
}


def _splits(ops, probs, cols: int):
    slots = getattr(ops, "cluster_slots", None)  # absent in a checkout without clusters
    return wide._splits(True, probs, cols, slots) if slots else wide._splits(True, probs, cols)


def last_launch(lib) -> Dict[str, int]:
    """The last bf16 weight-grad launch of a library (``fused_mlp_bwd`` or
    ``fused_mlp_wide``): its cluster size, grid and problem count; {}
    where the library does not say (a checkout without clusters)."""
    fn = getattr(lib, "nerf_wgrad_last_launch", None)
    if fn is None:
        return {}
    got = (ctypes.c_int * 4)()
    fn(ctypes.addressof(got))
    return dict(zip(("cluster", "grid_x", "grid_y", "problems"), got))


class Case:
    """A case's workspace rows (and per-ray rows), bias partials and
    problem list, made from a seed on the card."""

    def __init__(self, shape, ops, dev, seed: int = 0):
        W, n, spr, scenes = shape
        ke, kv = fused_mlp.embed_pad(10, 4)
        self.W, self.scenes, self.dense = W, scenes, spr == 1
        gen = torch.Generator(device=dev).manual_seed(seed)
        rows = fused_mlp.ws_rows(W, ke, kv)[1]
        self.ws = torch.randn(rows, scenes * n, device=dev, generator=gen).to(torch.bfloat16)
        rays = wide.cols(n // spr) if spr > 1 else 0
        self.rws = None if self.dense else torch.randn(
            kv + W // 2, scenes * rays, device=dev, generator=gen).to(torch.bfloat16)
        self.nbias = 9 * W + W // 2 + 4
        self.bpart = torch.randn(scenes * n // wide.TILE, self.nbias, device=dev, generator=gen)
        self.probs = wide._problems(W, ke, kv, self.dense)
        self.split_len, self.nsplit = _splits(ops, self.probs, n)
        self.grad_size = wide._grad_offsets(W, ke, kv)[1]

    def run(self, impl) -> torch.Tensor:
        out = torch.full((self.scenes, self.grad_size + self.nbias), float("nan"),
                         device=self.ws.device)
        impl.wgrad(self.ws, self.rws, self.probs, self.split_len, self.nsplit, self.grad_size,
                   out, self.bpart, self.scenes)
        return out

    def exact(self) -> torch.Tensor:
        """The scenes' weight grads with every product summed in f64."""
        out = torch.zeros(self.scenes, self.grad_size, dtype=torch.float64, device=self.ws.device)
        C = self.ws.shape[1] // self.scenes
        Cr = 0 if self.rws is None else self.rws.shape[1] // self.scenes
        for s in range(self.scenes):
            for q in self.probs:
                src, ra, M, rb, N, coff, ldc = q[:7]
                base, k = (self.rws, Cr) if src else (self.ws, C)
                cs = slice(s * k, (s + 1) * k)
                c = base[ra: ra + M, cs].double() @ base[rb: rb + N, cs].double().T
                out[s, coff: coff + (M - 1) * ldc + N].as_strided((M, N), (ldc, 1)).copy_(c)
        return out

    def worst_rel_l2(self, got: torch.Tensor, want: torch.Tensor) -> float:
        """The largest relative L2 over the scenes' weight grads (each
        product's block) and, where ``want`` has them, bias sums."""
        worst = 0.0
        for q in self.probs:
            M, N, coff, ldc = q[2], q[4], q[5], q[6]
            for g, w in zip(got.double(), want.double()):
                a = g[coff: coff + (M - 1) * ldc + N].as_strided((M, N), (ldc, 1))
                b = w[coff: coff + (M - 1) * ldc + N].as_strided((M, N), (ldc, 1))
                worst = max(worst, float((a - b).norm() / b.norm().clamp_min(1e-30)))
        if want.shape[1] > self.grad_size:
            b = want[:, self.grad_size:]
            worst = max(worst, float((got[:, self.grad_size:] - b).norm() / b.norm()))
        return worst


def check(path: str = "") -> int:
    """Each case against its plain version and its second launch; returns
    the count of cases that failed."""
    dev = torch.device("cuda")
    ops, plain = wide.Ops(torch.bfloat16, dev), wide.PlainOps()
    saved, bad = {}, 0
    for name in CASES:
        case = Case(CASES[name], ops, dev)
        got, again = case.run(ops), case.run(ops)
        torch.cuda.synchronize()
        launch = last_launch(ops.lib)
        want = case.run(plain)
        rel = case.worst_rel_l2(got, want)
        exact = case.exact()
        rel_exact, plain_exact = case.worst_rel_l2(got, exact), case.worst_rel_l2(want, exact)
        same = torch.equal(got, again)
        ok = rel <= REL_L2 and same and bool(torch.isfinite(got).all())
        bad += not ok
        print(json.dumps({"case": name, "W": case.W, "columns": case.ws.shape[1],
                          "scenes": case.scenes, "dense": case.dense,
                          "problems": len(case.probs), "split_len": case.split_len,
                          "nsplit": case.nsplit, **launch, "rel_l2": rel, "tol": REL_L2,
                          "rel_l2_f64": rel_exact, "plain_rel_l2_f64": plain_exact,
                          "second_launch_bit_equal": same, "ok": ok}), flush=True)
        saved[name] = got.cpu()
        del case, got, again, want, exact
        torch.cuda.empty_cache()
    if path:
        torch.save(saved, path)
    return bad


def compare(a: str, b: str) -> int:
    """1 where any case of two ``check`` files differs, else 0."""
    x, y = torch.load(a), torch.load(b)
    differ = [k for k in sorted(set(x) | set(y))
              if k not in x or k not in y or not torch.equal(x[k], y[k])]
    print(json.dumps({"cases": len(x), "bit_equal": len(differ) == 0, "differ": differ}))
    return int(bool(differ))


def _ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def step_times(W: int, dev) -> Dict[str, float]:
    """ms a training step (N_rand 4096 at 64 and at 192 samples, a
    direction per ray) of the weight-grad launch, its bound and the same
    products as bf16 torch.matmul on the same rows."""
    ops = wide.Ops(torch.bfloat16, dev)
    ke, kv = fused_mlp.embed_pad(10, 4)
    res = dict.fromkeys(("ms", "bytes_ms", "ops_ms", "library_ms"), 0.0)
    for S in LEVELS:
        case = Case((W, N_RAND * S, S, 1), ops, dev, seed=S)
        out = torch.empty(1, case.grad_size + case.nbias, device=dev)
        res["ms"] += _ms(lambda: ops.wgrad(case.ws, case.rws, case.probs, case.split_len,
                                           case.nsplit, case.grad_size, out, case.bpart))
        res["launch"] = last_launch(ops.lib)
        res["nsplit"] = case.nsplit
        ws, rws = case.ws, case.rws
        products = [((rws if q[0] else ws)[q[1]: q[1] + q[2]], (rws if q[0] else ws)[q[3]: q[3] + q[4]])
                    for q in case.probs]
        res["library_ms"] += _ms(lambda: [torch.matmul(a, b.T) for a, b in products])
        n = N_RAND * S
        rows = set()
        for q in case.probs:
            if q[0] == 0:
                rows |= set(range(q[1], q[1] + q[2])) | set(range(q[3], q[3] + q[4]))
        io = len(rows) * n * 2 + (kv + W // 2) * N_RAND * 2 + case.grad_size * 4
        flops = sum(2 * q[2] * q[4] * (N_RAND if q[0] else n) for q in case.probs)
        res["bytes_ms"] += 1e3 * io / PEAK_BYTES
        res["ops_ms"] += 1e3 * flops / PEAK_FLOPS
        del case, products, ws, rws, out
        torch.cuda.empty_cache()
    res["bound_ms"] = max(res["bytes_ms"], res["ops_ms"])
    return res


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("wgrad_check: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["check"] and len(argv) <= 2:
        return int(check(argv[1] if len(argv) > 1 else "") > 0)
    if argv[:1] == ["compare"] and len(argv) == 3:
        return compare(argv[1], argv[2])
    if argv == ["time"]:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        dev = torch.device("cuda")
        res = {"card": smi.stdout.strip(), "source": str(_build.CSRC)}
        for W in (256, 512):
            res[f"W{W}"] = step_times(W, dev)
        print(json.dumps(res), flush=True)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
