"""K7: probes of K1's forward tile, to see what serializes against the
tensor cores.

Counterpart of tools/probe_overlap.py, whose eight Pallas bodies take K1's
tile apart: the bare chain of 8 [T,256]@[256,256] bf16 products, then with
bias+relu, then as two interleaved half-tiles; the posenc front end with
real, no (·0.5, ·0.25) or polynomial trig, plain or interleaved; and the
full head. Here each body is a branch of one CUDA kernel built from K1's own
tile code (``csrc/probe_overlap.cu``), so the gaps between the bodies' times
say what K1's epilogue and trig cost beside its ``mma.sync`` stream. A ninth
body, ``products``, has no counterpart in the script: the same 8 products,
each of x, summed in the accumulators, with no epilogue between layers, so
that its time is the product stream's alone.

Run on the card, at the script's size (nothing is computed at import):

    python -m nerf_tpu_torch.tools.probe_overlap

The pieces:
- ``make_inputs``: the script's arrays from ``numpy.random.default_rng(seed)``
  in its order (x_in, Ws, bs, x3, v3, W0e, W5e, Wvf, Wve, Wout);
- ``probe_reference(body, inputs)``: the plain PyTorch version of a body,
  operands rounded to bf16 and products summed in f32, rounded to bf16 only
  where the script's body writes ``.astype(jnp.bfloat16)``. It keeps the
  script's quirks: layer 0 of the embedding bodies takes ``bs[0]``, ``full``
  uses ``Ws[0]`` as its feature weight, the view embedding is per ray of
  ``spr`` points, and ``poly`` rounds half to even;
- ``probe(body, inputs)``: the wrapper. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel (``probe.launches`` counts
  them) or raises;
- ``probe_flops`` / ``probe_bytes``: each body's own work, for its bound;
- ``main``: 1 warm-up and ``REPS`` launches of every body timed with CUDA
  events, in ``ROUNDS`` windows spread over the run; a body's time is the
  median of its windows, beside its bound, its plain version and, for
  ``matmul_only``, the chain of 8 bf16 ``torch.matmul`` that computes it.
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.ops import _build
from nerf_tpu_torch.ops.fused_mlp import _raise_on, kernel_blobs

SCRIPT_BODIES = ("matmul_only", "bias_relu", "interleaved", "embed_trunk", "embed_trunk_il",
                 "embed_notrig", "embed_poly", "full")
BODIES = SCRIPT_BODIES + ("products",)  # the kernel's body enum, in order
X_IN = ("matmul_only", "bias_relu", "interleaved", "products")  # read x [N, W] bf16
NPTS = 4096 * 192  # the script's size: 4,096 rays of 192 points
# REPS timed launches a body after one warm-up (the script's 30), in ROUNDS
# windows, every other round in reverse body order, so that a slow stretch
# of the card's clock costs one window of a body and not its median
REPS, ROUNDS, SEED = 30, 5, 0
WIDTH, DEPTH, SPR = 256, 8, 192  # the kernel is built for WIDTH
POINT_FREQS, VIEW_FREQS = 10, 4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


@dataclasses.dataclass(frozen=True)
class ProbeInputs:
    """The script's arrays: x [N, W] bf16; Ws [W, W] bf16 and bs [1, W] f32
    (DEPTH each); x3 [N, 3] and v3 [N/spr, 3] f32; W0e, W5e [63, W],
    Wvf [W, W/2], Wve [27, W/2], Wout [3W/2, 4] bf16."""

    x: torch.Tensor
    Ws: tuple
    bs: tuple
    x3: torch.Tensor
    v3: torch.Tensor
    W0e: torch.Tensor
    W5e: torch.Tensor
    Wvf: torch.Tensor
    Wve: torch.Tensor
    Wout: torch.Tensor
    spr: int

    @property
    def npts(self) -> int:
        return self.x3.shape[0]

    @property
    def width(self) -> int:
        return self.x.shape[1]

    def to(self, device) -> "ProbeInputs":
        def mv(t):
            return tuple(a.to(device) for a in t) if isinstance(t, tuple) else t.to(device)

        return ProbeInputs(**{f.name: mv(getattr(self, f.name)) if f.name != "spr" else self.spr
                              for f in dataclasses.fields(self)})

    @functools.cached_property
    def kernel_buffers(self):
        """(wt [DEPTH, W, W] = W_iᵀ, b [DEPTH, W]; K1's weight and bias
        blobs of the embedding bodies), built once per inputs. The blobs
        are K1's layout with W05e = [W0e | W5e], W1..W7 = Ws[1:], Wf =
        Ws[0] and zero biases where the script adds none."""
        wt = torch.stack([w.T for w in self.Ws]).contiguous()
        b = torch.cat(self.bs).contiguous()
        W = self.width
        zeros = lambda n: torch.zeros(1, n, dtype=torch.float32, device=b.device)  # noqa: E731
        kp = {"W05e": torch.cat([self.W0e, self.W5e], 1), "Wf": self.Ws[0], "Wvf": self.Wvf,
              "Wve": self.Wve, "Wout": self.Wout, "bf": zeros(W), "bv": zeros(W // 2),
              "bout": zeros(4)}
        for i in range(DEPTH):
            kp[f"b{i}"] = self.bs[i]
            if i > 0:
                kp[f"W{i}"] = self.Ws[i]
        return (wt, b) + kernel_blobs(kp)


def make_inputs(npts: int = NPTS, width: int = WIDTH, spr: int = SPR, seed: int = SEED,
                scale: float = 0.05) -> ProbeInputs:
    """The script's arrays (tools/probe_overlap.py:33-36, :117-129) on the
    CPU, drawn in its order, DEPTH layers; ``scale`` is the weights'
    standard deviation (0.05 there)."""
    if npts % spr:
        raise ValueError(f"spr={spr} must divide npts={npts}")
    rng = np.random.default_rng(seed)

    def normal(*shape, s=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * s)

    x = normal(npts, width).bfloat16()
    Ws = tuple(normal(width, width, s=scale).bfloat16() for _ in range(DEPTH))
    bs = tuple(normal(1, width, s=0.01) for _ in range(DEPTH))
    x3 = normal(npts, 3)
    v3 = normal(npts // spr, 3)
    W0e = normal(63, width, s=scale).bfloat16()
    W5e = normal(63, width, s=scale).bfloat16()
    Wvf = normal(width, width // 2, s=scale).bfloat16()
    Wve = normal(27, width // 2, s=scale).bfloat16()
    Wout = normal(width + width // 2, 4, s=scale).bfloat16()
    return ProbeInputs(x, Ws, bs, x3, v3, W0e, W5e, Wvf, Wve, Wout, spr)


# ------------------------------------------------------------ plain versions


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back (the script's ``.astype(jnp.bfloat16)``)."""
    return t.bfloat16().float()


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(a, b, preferred_element_type=f32)`` of bf16 operands."""
    return _bf(a) @ _bf(b)


def poly_sincos(xb: torch.Tensor):
    """The script's shared range reduction and minimax polynomials."""
    y = xb * 0.15915494309189535
    r = (y - torch.round(y)) * 6.283185307179586  # torch.round: half to even
    r2 = r * r
    s = r * (0.9999845940079196 + r2 * (-0.16663259474612063 + r2 * (
        0.008312388725549872 + r2 * (-0.00019316277202555934 + r2 * 2.1732608711915083e-06))))
    c = 0.9999994437337446 + r2 * (-0.4999955824558693 + r2 * (
        0.04166103368789301 + r2 * (-0.0013862750536381093 + r2 * (
            2.4253237753182864e-05 + r2 * -2.2194166856720897e-07))))
    return s, c


def _embed(x: torch.Tensor, num_freqs: int, trig: str = "sin") -> torch.Tensor:
    """[x | s(x 2^f) | c(x 2^f)] with column 3f+d, rounded to bf16: the
    script's ``embed`` (sin, cos), ``embed_notrig`` (·0.5, ·0.25) or
    ``embed_poly``. Its selector product x·Sp is exact (one power of two a
    column), so it is a multiply here."""
    scale = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = (x[:, None, :] * scale[:, None]).reshape(x.shape[0], 3 * num_freqs)
    if trig == "sin":
        s, c = torch.sin(xb), torch.cos(xb)
    elif trig == "notrig":
        s, c = xb * 0.5, xb * 0.25
    else:
        s, c = poly_sincos(xb)
    return torch.cat([_bf(x), _bf(s), _bf(c)], -1)


def _trunk_from_embedding(inp: ProbeInputs, e: torch.Tensor) -> torch.Tensor:
    h = _bf(torch.relu(_dot(e, inp.W0e) + inp.bs[0]))
    for i in range(1, DEPTH):
        z = _dot(h, inp.Ws[i]) + inp.bs[i]
        if i == 5:
            z = z + _dot(e, inp.W5e)
        h = _bf(torch.relu(z))
    return h


def probe_reference(body: str, inp: ProbeInputs) -> torch.Tensor:
    """Plain PyTorch version of a probe body: out [N, W] float32."""
    if body == "products":
        return _bf(sum(_dot(inp.x, w) for w in inp.Ws))
    if body in X_IN:
        h = inp.x.float()
        for w, b in zip(inp.Ws, inp.bs):
            h = _bf(_dot(h, w)) if body == "matmul_only" else _bf(torch.relu(_dot(h, w) + b))
        return h
    trig = {"embed_notrig": "notrig", "embed_poly": "poly"}.get(body, "sin")
    if body not in BODIES:
        raise ValueError(f"unknown probe body {body!r}; one of {BODIES}")
    e = _embed(inp.x3, POINT_FREQS, trig)
    h = _trunk_from_embedding(inp, e)
    if body != "full":
        return h
    feat = _dot(h, inp.Ws[0])
    ev_c = _dot(_embed(inp.v3, VIEW_FREQS), inp.Wve).repeat_interleave(inp.spr, 0)
    hv = torch.relu(_dot(_bf(feat), inp.Wvf) + ev_c)
    out4 = _dot(torch.cat([_bf(hv), h], -1), inp.Wout)
    return F.pad(out4, (0, inp.width - 4))


# ------------------------------------------------------------------ kernel


def probe(body: str, inp: ProbeInputs) -> torch.Tensor:
    """A probe body's output [N, W] float32. CUDA tensors launch the kernel
    (``launches`` counts them); CPU tensors take the plain version."""
    if body not in BODIES:
        raise ValueError(f"unknown probe body {body!r}; one of {BODIES}")
    dev = inp.x3.device
    if dev.type == "cpu":
        return probe_reference(body, inp)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    if inp.width != WIDTH:
        raise ValueError(f"the probe kernel is built for width {WIDTH}, not {inp.width}")
    lib = _build.load("probe_overlap")
    wt, b, wblob, bblob = inp.kernel_buffers
    out = torch.empty(inp.npts, inp.width, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_probe_overlap(
            BODIES.index(body), inp.npts, inp.spr, inp.x.data_ptr(), inp.x3.data_ptr(),
            inp.v3.data_ptr(), wt.data_ptr(), b.data_ptr(), wblob.data_ptr(), bblob.data_ptr(),
            out.data_ptr(), stream,
        )
    _raise_on(lib, err, f"probe_overlap ({body})")
    probe.launches += 1
    return out


probe.launches = 0


# ------------------------------------------------------------------ bounds


def probe_flops(body: str) -> int:
    """The body's tensor-core FLOP at the script's size (2 per
    multiply-add of its products).
    The trunk bodies: 8 W×W layers; the embedding bodies: layer 0 and the
    skip from the 63-wide embedding, layers 1..7; ``full`` adds the feature
    (W×W), view (W×W/2 a point, 27×W/2 a ray) and head (3W/2×4) products.
    Bias, relu and trig run on other units that could overlap the
    products, so the bound leaves them out."""
    W, npts, spr = WIDTH, NPTS, SPR
    if body in X_IN:
        return npts * DEPTH * 2 * W * W
    macs = 2 * 63 * W + (DEPTH - 1) * W * W
    flops = npts * 2 * macs
    if body == "full":
        flops += npts * 2 * (W * W + W * (W // 2) + (W + W // 2) * 4)
        flops += (npts // spr) * 2 * 27 * (W // 2)
    return flops


def probe_bytes(body: str) -> int:
    """Bytes the body must move at the script's size: each input it reads
    once, out once."""
    W, npts, spr = WIDTH, NPTS, SPR
    out = npts * W * 4
    if body in X_IN:
        return npts * W * 2 + DEPTH * (W * W * 2 + W * 4) + out
    weights = 2 * 63 * W * 2 + (DEPTH - 1) * W * W * 2 + DEPTH * W * 4
    if body == "full":
        weights += W * W * 2 + W * (W // 2) * 2 + 27 * (W // 2) * 2 + (W + W // 2) * 4 * 2
        return npts * 12 + (npts // spr) * 12 + weights + out
    return npts * 12 + weights + out


def probe_bound_ms(body: str):
    """(least time on an H100 in ms at the script's size, "operations" or
    "bytes")."""
    ops_ms = 1e3 * probe_flops(body) / PEAK_BF16_FLOPS
    bytes_ms = 1e3 * probe_bytes(body) / PEAK_BYTES
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


# ------------------------------------------------------------------ timing


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``reps`` calls."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def matmul_chain(inp: ProbeInputs) -> torch.Tensor:
    """``matmul_only`` as 8 bf16 ``torch.matmul`` calls, each rounding its
    f32 sums to bf16 as the body does: a library yardstick, timed only."""
    h = inp.x
    for w in inp.Ws:
        h = torch.matmul(h, w)
    return h


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(device: DeviceLike = None) -> List[Dict]:
    """Time every body on the card at the script's size: 1 warm-up launch
    (held against the plain version), then ``REPS`` timed launches in
    ``ROUNDS`` windows; a body's ms is the median of its windows' means,
    beside its bound, the plain version's time and, for ``matmul_only``,
    the bf16 ``torch.matmul`` chain's (timed in the same windows). Prints a
    line a body and returns them as dicts."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the probes time the card; got device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = make_inputs().to(dev)
    print(nvidia_smi(), flush=True)
    rows = {}
    for body in BODIES:
        out = probe(body, inp)  # the warm-up launch
        ref = probe_reference(body, inp)
        err, ref_max = float((out - ref).abs().max()), float(ref.abs().max())
        del out, ref
        plain_ms = cuda_ms(lambda: probe_reference(body, inp), reps=2)
        torch.cuda.empty_cache()
        rows[body] = {"body": body, "plain_ms": plain_ms, "max_abs_err": err,
                      "plain_max_abs": ref_max, "windows": []}
    matmul_chain(inp)  # its warm-up
    chain = []
    for r in range(ROUNDS):
        for body in BODIES if r % 2 == 0 else BODIES[::-1]:
            rows[body]["windows"].append(cuda_ms(lambda: probe(body, inp), REPS // ROUNDS))
        chain.append(cuda_ms(lambda: matmul_chain(inp), REPS // ROUNDS))
    for body, row in rows.items():
        ms = float(np.median(row["windows"]))
        bound_ms, bound_by = probe_bound_ms(body)
        tflops = probe_flops(body) / ms / 1e9
        library_ms = float(np.median(chain)) if body == "matmul_only" else None
        row.update(ms=ms, tflops=tflops, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms)
        lib = "" if library_ms is None else f"  torch.matmul chain {library_ms:8.3f} ms"
        print(f"{body:15s} {ms:8.3f} ms (windows {min(row['windows']):.3f}-"
              f"{max(row['windows']):.3f})  {tflops:6.1f} TFLOP/s  {tflops / 989:6.1%} of 989  "
              f"bound {bound_ms:.3f} ms ({bound_by})  plain {row['plain_ms']:8.3f} ms  "
              f"max|kernel-plain| {row['max_abs_err']:.3e}{lib}", flush=True)
    return list(rows.values())


if __name__ == "__main__":
    main()
