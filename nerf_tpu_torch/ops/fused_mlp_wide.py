"""The wide kernel family: K1-K4 at the widths and octave counts that the
W <= 256 tile is not built for (csrc/fused_mlp_wide.cu).

nerf_tpu runs its Pallas kernels at any width that is a multiple of 128 and
at any octave count (nerf_tpu/ops/fused_mlp.py::supports); the port's bf16
tile (csrc/fwd_tile_sm90.cuh) is built for W in {128, 256} with at most 10
point and 4 view octaves. ``ops/fused_mlp.py``'s wrappers send every other
configuration here on a CUDA tensor (``fused_mlp.is_wide``); on a CPU tensor
they take the same plain versions as the tile's configurations.

Every activation lives feature-major in device memory (a row per feature, a
column per point: the backward's workspace rows, ``fused_mlp.ws_rows`` at the
configuration's padded embedding widths ``fused_mlp.embed_pad``), and every
layer is one launch of the family's GEMM (``Ops.gemm``). The launch plans:

- K1w (``fused_rays_planes_wide``) / K2w (``fused_points_wide``): the
  embedding rows, the layers with W^T as A (the skip's embedding half and,
  with a direction per point, the view embedding as a second source; with a
  direction per ray, Wve's product per ray added in the view layer's
  epilogue), the head; over slices of at most ``SLICE_POINTS`` points;
- K4w (``fused_rays_planes_wide_bwd``) / K3w (``fused_points_wide_bwd``):
  the same forward into the workspace rows, the cotangent chain with W as A
  (gc's rank-4 terms a k = 4 source), the per-ray sums of d_hv, with input
  grads d_e and d_ev and the posenc backward, then the weight grads
  (``wgrad_sm90.cuh``, phase 3 of the tile's backward) over the rows.

The stacked (multi-scene) plans, K1ws / K4ws (``rays_planes_stacked{,_bwd}``)
and K2ws / K3ws (``points_raw_stacked``, ``points_stacked_bwd``), run the
same launches once for S nets of one shape (leaves with a leading scene
axis; nerf_tpu vmaps its kernels over the scenes): each scene's rays (views)
are zero-padded to ``cols`` of them, so its columns are whole GEMM tiles,
one after another; every GEMM reads scene s's weights, bias and per-view
terms for scene s's columns, the head its Wout and bout, and the weight
grads give each scene its own set. No launch loops over the scenes. The
single-scene backward lays a scene's columns out the same way (S = 1), so
the stacked plans' scene s is the single-scene plan's bit for bit.

``Ops`` launches the primitives of csrc/fused_mlp_wide.cu; ``PlainOps`` is
the plain PyTorch version of each, on the same tensors, so a launch plan can
run on the CPU against the kernels' plain versions
(tests/test_torch_port_fused_mlp.py, tests/test_torch_port_multi.py) and
each primitive be held to its plain version on the card
(tests/test_torch_port_kernels.py). Each wrapper counts its calls in
``launches`` (one a call, whatever the launches it makes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from nerf_tpu_torch.ops import _build, fused_mlp

TILE = 256  # columns of a GEMM tile and of a bias partial (WIDE_TILE in the source)
SLICE_POINTS = 1 << 20  # the forwards' points a slice: bounds their scratch rows
WG_M, WG_N = 128, 256  # a bf16 weight-grad CTA's tile of C (GM, GN in csrc/wgrad_sm90.cuh)
SMS, MAX_SPLIT_CHUNKS = 132, 256  # as csrc/fused_mlp_bwd.cu's hopper_splits


def cols(n: int) -> int:
    """n columns rounded up to whole GEMM tiles (also a scene's padded rays
    or views in the stacked plans)."""
    return -(-n // TILE) * TILE


def _in_scene(t: Optional[torch.Tensor], s: int, dims: int) -> Optional[torch.Tensor]:
    """Scene s's slice of a tensor with a leading scene axis (``dims`` + 1
    dimensions), or the tensor itself (one scene)."""
    return t[s] if t is not None and t.dim() == dims + 1 else t


class PlainOps:
    """The plain PyTorch version of each primitive of csrc/fused_mlp_wide.cu
    (and of K5w's and K6w's compositing passes), on the same tensors as
    ``Ops`` (bf16 rows round where a kernel stores them, every sum in f32)."""

    def embed(self, out, F_, n, rays=None, x=None):
        """out [K, >= ncols] rows of the F_-octave embedding of the columns
        0 .. out.shape[1]-1: points of rays (ro, rd, z, spr) or of x [n, 3];
        x = 0 past n."""
        ncols = out.shape[1]
        pts = fused_mlp._ray_points(*rays[:3]) if rays is not None else x[:n]
        pts = F.pad(pts, (0, 0, 0, ncols - n))
        emb = fused_mlp._embed(pts, F_)
        out.copy_(F.pad(emb, (0, out.shape[0] - emb.shape[1])).T)

    def gemm(self, M, N, srcs, bias=None, add=None, add_div=1, mask=None, relu=False, out=None,
             out32=None, bsum=None, scenes=1):
        C = N // scenes
        per = []  # scene s's columns from its own A, bias and per-view terms
        for s in range(scenes):
            cs = slice(s * C, (s + 1) * C)
            acc = sum(_in_scene(a, s, 2)[:, :k].float() @ b[:k, cs].float().contiguous()
                      for a, k, b in srcs)
            if add is not None:
                acc = acc + _in_scene(add, s, 2)[:, torch.arange(C, device=acc.device) // add_div]
            if bias is not None:
                acc = acc + _in_scene(bias, s, 1)[:, None]
            per.append(acc)
        acc = torch.cat(per, 1)
        if relu:
            acc = torch.relu(acc)
        if mask is not None:
            acc = torch.where(mask[:, :N].float() > 0, acc, torch.zeros_like(acc))
        if bsum is not None:
            bsum[: N // TILE, :M] = acc.reshape(M, N // TILE, TILE).sum(-1).T
        if out is not None:
            out[:, :N] = acc
        if out32 is not None:
            out32[:, :N] = acc

    def head(self, hv, h7, n, W, wout, bout, out, C=None):
        C = n if C is None else C
        for s in range(-(-n // C)):
            p0, p1 = s * C, min(n, (s + 1) * C)
            w = _in_scene(wout, s, 2).float()
            raw = (hv[:, p0:p1].T.float() @ w[: W // 2] + h7[:, p0:p1].T.float() @ w[W // 2:]
                   + _in_scene(bout, s, 1))
            out[:, p0:p1] = raw.T

    def gc(self, g, n, rows, bsum):
        ncols = rows.shape[1]
        gp = F.pad(g[:, :n], (0, ncols - n)).contiguous()  # each tile's sum in one order
        rows[:4] = gp
        rows[4:8] = 0
        bsum[: ncols // TILE, :4] = gp.reshape(4, -1, TILE).sum(-1).T

    def ray_sums(self, dhv32, n_rays, spr, out):
        H, rpad = out.shape
        s = dhv32[:, : n_rays * spr].reshape(H, n_rays, spr).sum(-1)
        out.copy_(F.pad(s, (0, rpad - n_rays)))

    def embed_bwd(self, y, n, F_, de, out):
        out[:n] = fused_mlp._embed_backward(de[: 3 + 6 * F_, :n].T, y[:n], F_)

    def composite(self, raw, rays_d, z_vals, noise, white_bkgd):
        return _render().composite_maps_reference(raw, rays_d, z_vals, noise, white_bkgd)

    def composite_bwd(self, *args):
        return _render().composite_bwd_reference(*args)

    def cluster_slots(self, cl: int) -> int:
        """The H100 SXM's 132 SMs in whole clusters of cl: the split count's
        stand-in for the card's answer (``Ops.cluster_slots``); the plain
        weight grads sum each product whole, whatever the splits."""
        return default_slots(cl)

    def wgrad(self, ws, rws, probs, split_len, nsplit, grad_size, out, bpart, scenes=1):
        C, T = ws.shape[1] // scenes, bpart.shape[0] // scenes
        Cr = 0 if rws is None else rws.shape[1] // scenes
        for s in range(scenes):
            for src, ra, M, rb, N, coff, ldc, _, _ in probs:
                base, k = (rws, Cr) if src else (ws, C)
                cs = slice(s * k, (s + 1) * k)
                c = base[ra : ra + M, cs].float() @ base[rb : rb + N, cs].float().T
                out[s, coff : coff + (M - 1) * ldc + N].as_strided((M, N), (ldc, 1)).copy_(c)
            out[s, grad_size:] = bpart[s * T : (s + 1) * T].sum(0)


def _render():
    """experimental/fused_render.py (imported at first use: it imports this
    module), whose compositing launches K5w and K6w take."""
    from nerf_tpu_torch.experimental import fused_render

    return fused_render


def _p(t: Optional[torch.Tensor]):
    return 0 if t is None else t.data_ptr()


def _ld(t: Optional[torch.Tensor], dims: int = 2) -> int:
    """Elements between rows of a [rows][cols] tensor, or of its scenes'
    ([S][rows][cols], ``dims`` = 2)."""
    return 0 if t is None else t.stride(-2) if t.dim() == dims + 1 else t.stride(0)


def _sc(t: Optional[torch.Tensor], dims: int) -> int:
    """Elements between two scenes' slices of a tensor with a leading scene
    axis (``dims`` + 1 dimensions); 0 for one scene."""
    return t.stride(0) if t is not None and t.dim() == dims + 1 else 0


class Ops:
    """The primitives of csrc/fused_mlp_wide.cu (and K5w's and K6w's
    compositing passes, csrc/fused_render.cu) on CUDA tensors of one
    device, each one launch (the weight grads one, with its reductions) on
    its current stream; a launch that fails raises."""

    def __init__(self, dtype: torch.dtype, device: torch.device):
        self.lib = _build.load("fused_mlp_wide")
        self.bf16 = int(dtype == torch.bfloat16)
        self.device = device
        self.stream = torch.cuda.current_stream(device).cuda_stream

    def _run(self, name: str, *args) -> None:
        with torch.cuda.device(self.device):
            err = getattr(self.lib, name)(*args)
        fused_mlp._raise_on(self.lib, err, name)

    def embed(self, out, F_, n, rays=None, x=None):
        if rays is not None:
            ro, rd, z, spr = rays
            self._run("nerf_wide_embed", self.bf16, 1, ro.data_ptr(), rd.data_ptr(), z.data_ptr(),
                      0, n, spr, F_, out.shape[0], out.data_ptr(), _ld(out), out.shape[1],
                      self.stream)
        else:
            self._run("nerf_wide_embed", self.bf16, 0, 0, 0, 0, x.data_ptr(), n, 1, F_,
                      out.shape[0], out.data_ptr(), _ld(out), out.shape[1], self.stream)

    def gemm(self, M, N, srcs, bias=None, add=None, add_div=1, mask=None, relu=False, out=None,
             out32=None, bsum=None, scenes=1):
        (a0, k0, b0), (a1, k1, b1) = srcs[0], srcs[1] if len(srcs) > 1 else (None, 0, None)
        self._run("nerf_wide_gemm", self.bf16, scenes, M, N // scenes,
                  _p(a0), _ld(a0, 2), _sc(a0, 2), k0, _p(b0), _ld(b0),
                  _p(a1), _ld(a1, 2), _sc(a1, 2), k1, _p(b1), _ld(b1),
                  _p(bias), _sc(bias, 1), _p(add), _ld(add, 2), _sc(add, 2), add_div,
                  _p(mask), _ld(mask), int(relu), _p(out), _ld(out), _p(out32), _ld(out32),
                  _p(bsum), _ld(bsum), self.stream)

    def head(self, hv, h7, n, W, wout, bout, out, C=None):
        self._run("nerf_wide_head", self.bf16, hv.data_ptr(), h7.data_ptr(), _ld(hv), n,
                  max(1, n) if C is None else C, W, wout.data_ptr(), _sc(wout, 2),
                  bout.data_ptr(), _sc(bout, 1), out.data_ptr(), out.stride(0), out.stride(1),
                  self.stream)

    def gc(self, g, n, rows, bsum):
        self._run("nerf_wide_gc", self.bf16, g.data_ptr(), g.stride(0), g.stride(1), n,
                  rows.shape[1], rows.data_ptr(), _ld(rows), bsum.data_ptr(), _ld(bsum),
                  self.stream)

    def ray_sums(self, dhv32, n_rays, spr, out):
        self._run("nerf_wide_ray_sums", self.bf16, dhv32.data_ptr(), _ld(dhv32), n_rays, spr,
                  out.shape[0], out.data_ptr(), _ld(out), out.shape[1], self.stream)

    def embed_bwd(self, y, n, F_, de, out):
        self._run("nerf_wide_embed_bwd", y.data_ptr(), n, F_, de.data_ptr(), _ld(de),
                  out.data_ptr(), self.stream)

    def composite(self, raw, rays_d, z_vals, noise, white_bkgd):
        return _render().launch_composite_maps(raw, rays_d, z_vals, noise, white_bkgd)

    def composite_bwd(self, *args):
        return _render()._launch_composite_bwd(*args)

    def cluster_slots(self, cl: int) -> int:
        """CTAs of the bf16 weight-grad launch the card holds at once in
        clusters of cl (``nerf_wide_wgrad_slots``)."""
        n = ctypes.c_int(0)
        self._run("nerf_wide_wgrad_slots", cl, ctypes.byref(n))
        return n.value

    def wgrad(self, ws, rws, probs, split_len, nsplit, grad_size, out, bpart, scenes=1):
        flat = (ctypes.c_int * (9 * len(probs)))(*[v for q in probs for v in q])
        wpart = torch.empty(scenes * nsplit * grad_size, dtype=torch.float32, device=ws.device)
        self._run("nerf_wide_wgrad", self.bf16, ws.data_ptr(), ws.shape[0], ws.shape[1],
                  _p(rws), 0 if rws is None else rws.shape[0], 0 if rws is None else rws.shape[1],
                  scenes, len(probs), ctypes.addressof(flat), split_len, nsplit, grad_size,
                  wpart.data_ptr(), out.data_ptr(), bpart.data_ptr(), bpart.shape[0],
                  bpart.shape[1], self.stream)


def _config(kp) -> Tuple[torch.dtype, int, int, int, int, int]:
    """(dtype, W, Fp, Fv, KE, KV) of packed params."""
    dtype = kp["W1"].dtype
    W = kp["W1"].shape[-1]
    Fp, Fv = fused_mlp._num_freqs(kp)
    return (dtype, W, Fp, Fv) + fused_mlp.embed_pad(Fp, Fv)


def _blocks(kp, blobs) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The forward's W^T blocks ([out][in] rows, the A of its products) and
    biases, as views of ``kernel_blobs(kp)`` (fused_mlp_common.cuh's Layout
    at the configuration's KE / KV); with stacked leaves, a leading scene
    axis on each (a scene's blobs after the one before)."""
    dtype, W, _, _, ke, kv = _config(kp)
    wblob, bblob = fused_mlp.kernel_blobs(kp) if blobs is None else blobs
    lead = tuple(kp["W1"].shape[:-2])
    wblob, bblob = wblob.view(*lead, -1), bblob.view(*lead, -1)
    w, o = {}, 0
    for name, rows, k in ([("w05", 2 * W, ke)] + [(f"w{i}", W, W) for i in range(1, 8)]
                          + [("wf", W, W), ("wvf", W // 2, W), ("wve", W // 2, kv)]):
        w[name] = wblob[..., o : o + rows * k].unflatten(-1, (rows, k))
        o += rows * k
    b, o = {}, 0
    for name, n in [(f"b{i}", W) for i in range(8)] + [("bf", W), ("bv", W // 2), ("bout", 4)]:
        b[name] = bblob[..., o : o + n]
        o += n
    return w, b


def _layers(ops, w, b, rows, W: int, ke: int, kv: int, N: int, view, scenes: int = 1) -> None:
    """The forward's layers over N columns (``scenes`` scenes' in turn, each
    on its own blocks), from the embedding rows rows["e"] into rows h0..h7,
    feat and hv (row views; a layer never writes the rows it reads).
    ``view``: ("src", ev rows) with a direction per column, or ("add",
    Wve's product per view [S, W/2, views] f32, spr)."""
    gemm = functools.partial(ops.gemm, scenes=scenes)
    gemm(W, N, [(w["w05"][..., :W, :], ke, rows["e"])], bias=b["b0"], relu=True, out=rows["h0"])
    for i in range(1, 8):
        srcs = [(w[f"w{i}"], W, rows[f"h{i - 1}"])]
        if i == fused_mlp.SKIP + 1:
            srcs.append((w["w05"][..., W:, :], ke, rows["e"]))
        gemm(W, N, srcs, bias=b[f"b{i}"], relu=True, out=rows[f"h{i}"])
    gemm(W, N, [(w["wf"], W, rows["h7"])], bias=b["bf"], out=rows["feat"])
    srcs = [(w["wvf"], W, rows["feat"])]
    if view[0] == "src":
        srcs.append((w["wve"], kv, view[1]))
        gemm(W // 2, N, srcs, bias=b["bv"], relu=True, out=rows["hv"])
    else:
        gemm(W // 2, N, srcs, bias=b["bv"], add=view[1], add_div=view[2], relu=True,
             out=rows["hv"])


def _view_terms(ops, w, v, nv: int, Fv: int, kv: int, W: int, dtype, ev_rows=None,
                scenes: int = 1):
    """("add", Wve's product per view [S, W/2, V] f32 (a view of [W/2, S V]),
    spr) for a direction per ray, from the view embedding rows (written to
    ``ev_rows`` [kv, S V], where given) of the nv views, V = cols(nv / S)
    a scene."""
    V = cols(-(-nv // scenes))
    ev = ev_rows if ev_rows is not None else torch.empty(kv, scenes * V, dtype=dtype,
                                                         device=v.device)
    ops.embed(ev, Fv, nv, x=v)
    evc = torch.empty(W // 2, scenes * V, dtype=torch.float32, device=v.device)
    ops.gemm(W // 2, scenes * V, [(w["wve"], kv, ev)], out32=evc, scenes=scenes)
    return evc.view(W // 2, scenes, V).permute(1, 0, 2)


def _forward(ops, kp, blobs, pieces, out4, scenes: int = 1) -> None:
    """K1w / K2w (K1ws / K2ws with ``scenes`` > 1: one piece, every scene's
    padded points): raw of every piece into out4 [4, points] (a strided
    view: planes or rows). ``pieces`` yields (points source: ("rays", ro,
    rd, z) or ("points", x), directions v, points n, spr, first point)
    slices."""
    dtype, W, Fp, Fv, ke, kv = _config(kp)
    w, b = _blocks(kp, blobs)
    scratch = None
    for src, v, n, spr, p0 in pieces:
        C = cols(-(-n // scenes))  # a scene's columns
        N = scenes * C
        if scratch is None or scratch[0].shape[1] < N:
            dev = v.device
            scratch = [torch.empty(r, N, dtype=dtype, device=dev) for r in (ke, W, W, W // 2)]
        e, A, B, hv = (t[:, :N] for t in scratch)
        rays = (src[1], src[2], src[3], spr) if src[0] == "rays" else None
        ops.embed(e, Fp, n, rays=rays, x=None if rays else src[1])
        if spr == 1:
            ev = torch.empty(kv, N, dtype=dtype, device=v.device)
            ops.embed(ev, Fv, n, x=v)
            view = ("src", ev)
        else:
            view = ("add", _view_terms(ops, w, v, n // spr, Fv, kv, W, dtype, scenes=scenes), spr)
        rows = {"e": e, "feat": A, "hv": hv, **{f"h{i}": A if i % 2 == 0 else B for i in range(8)}}
        _layers(ops, w, b, rows, W, ke, kv, N, view, scenes)
        ops.head(hv, B, n, W, kp["Wout"], b["bout"], out4[:, p0 : p0 + n], C)


def _ray_slices(rays_o, rays_d, viewdirs, z_vals):
    R, S = z_vals.shape
    step = max(1, SLICE_POINTS // S)
    for r0 in range(0, R, step):
        r1 = min(R, r0 + step)
        yield (("rays", rays_o[r0:r1], rays_d[r0:r1], z_vals[r0:r1]), viewdirs[r0:r1],
               (r1 - r0) * S, S, r0 * S)


def _point_slices(x, v, spr):
    nv = v.shape[0]
    step = max(1, SLICE_POINTS // spr)
    for v0 in range(0, nv, step):
        v1 = min(nv, v0 + step)
        yield ("points", x[v0 * spr : v1 * spr]), v[v0:v1], (v1 - v0) * spr, spr, v0 * spr


def rays_planes(ops, kp, rays_o, rays_d, viewdirs, z_vals, blobs=None) -> torch.Tensor:
    """K1w's launches: raw planes [4, R, S] float32."""
    R, S = z_vals.shape
    out = torch.empty(4, R, S, dtype=torch.float32, device=z_vals.device)
    args = [t.contiguous() for t in (rays_o, rays_d, viewdirs, z_vals)]
    _forward(ops, kp, blobs, _ray_slices(*args), out.view(4, R * S))
    return out


def points_raw(ops, kp, x, v, spr: int, blobs=None) -> torch.Tensor:
    """K2w's launches: raw [N, 4] float32."""
    out = torch.empty(x.shape[0], 4, dtype=torch.float32, device=x.device)
    _forward(ops, kp, blobs, _point_slices(x.contiguous(), v.contiguous(), spr), out.T)
    return out


def _grad_offsets(W: int, ke: int, kv: int) -> Tuple[Dict[str, int], int]:
    """(first float of each weight grad in the f32 output, the weights'
    floats): fused_mlp._grad_blocks' order."""
    weights, _ = fused_mlp._grad_blocks(W, ke, kv)
    off, o = {}, 0
    for name, r, c in weights:
        off[name] = o
        o += r * c
    return off, o


def cluster_shape(M: int, N: int) -> Tuple[int, int]:
    """(mc, nc): the bf16 weight-grad cluster of a product C[M][N], mc of its
    128-row tiles by nc of its 256-column ones whose CTAs share each K
    chunk's boxes by TMA multicast: the largest mc in (4, 2, 1) and nc in
    (2, 1) that divide C's tiles (at most 8 CTAs, the portable cluster);
    (1, 1) for dWout's 4 columns. csrc/wgrad_sm90.cuh's cluster_shape."""
    if N <= 8:
        return 1, 1
    mt, nt = -(-M // WG_M), -(-N // WG_N)
    return (4 if mt % 4 == 0 else 2 if mt % 2 == 0 else 1), (2 if nt % 2 == 0 else 1)


def _problems(W: int, ke: int, kv: int, dense: bool) -> List[Tuple[int, ...]]:
    """The weight grads as (src, ra, M, rb, N, coff, ldc, mc, nc) products
    over the workspace rows (src 0) or the per-ray rows (src 1: ev at row
    0, the rounded d_hv sums at row kv), each whole, with its cluster
    (``cluster_shape``): 14 products, one launch at every width."""
    blocks, _ = fused_mlp.ws_rows(W, ke, kv)
    chain = fused_mlp.chain_ws_rows(W, ke)
    row = {**{k: r for k, (r, _) in blocks.items()}, **{k: r for k, (r, _) in chain.items()}}
    off, _ = _grad_offsets(W, ke, kv)
    probs = []

    def add(src, ra, M, rb, N, coff, ldc):
        probs.append((src, ra, M, rb, N, coff, ldc, *cluster_shape(M, N)))

    add(0, row["e"], ke, row["d0"], W, off["W05e"], 2 * W)
    add(0, row["e"], ke, row["d5"], W, off["W05e"] + W, 2 * W)
    for i in range(1, 8):
        add(0, row[f"h{i - 1}"], W, row[f"d{i}"], W, off[f"W{i}"], W)
    add(0, row["h7"], W, row["dfeat"], W, off["Wf"], W)
    add(0, row["feat"], W, row["dhv"], W // 2, off["Wvf"], W // 2)
    add(0, row["hv"], W // 2, row["gc"], 4, off["Wout"], 4)
    add(0, row["h7"], W, row["gc"], 4, off["Wout"] + (W // 2) * 4, 4)
    if dense:
        add(0, row["ev"], kv, row["dhv"], W // 2, off["Wve"], W // 2)
    else:
        add(1, 0, kv, kv, W // 2, off["Wve"], W // 2)
    return probs


def default_slots(cl: int) -> int:
    """The H100 SXM's SMS in whole clusters of cl CTAs."""
    return SMS // cl * cl


def hopper_splits(tiles: int, nchunks: int, cl: int, slots: int) -> int:
    """csrc/fused_mlp_bwd.cu's hopper_splits: the bf16 weight-grad launch's
    split count for ``tiles`` CTAs a split over nchunks 64-point chunks, in
    clusters of cl CTAs of which the card holds ``slots`` at once."""
    smin = min(64, -(-nchunks // MAX_SPLIT_CHUNKS))
    smax = max(smin, min(64, nchunks // 8))
    best, best_fill = smin, 0.0
    for s in range(smin, smax + 1):
        ctas = -(-tiles * s // cl) * cl
        fill = ctas / (-(-ctas // slots) * slots)
        if fill >= 0.95:
            return s
        if fill > best_fill:
            best, best_fill = s, fill
    return best


def _splits(bf16: bool, probs, n_pad: int, slots=default_slots) -> Tuple[int, int]:
    """(split_len, nsplit) of the weight grads over n_pad columns, as the
    tile's backward picks them (make_plan); ``slots(cl)``: the CTAs the card
    holds at once in clusters of cl (``Ops.cluster_slots``)."""
    nchunks = n_pad // 64
    if bf16:
        tiles = sum(-(-q[2] // WG_M) * -(-q[4] // WG_N) for q in probs if q[0] == 0)
        cl = max(q[7] * q[8] for q in probs)
        target = hopper_splits(tiles, nchunks, cl, slots(cl))
    else:
        target = max(1, min(64, n_pad // 8192))
    split_len = -(-nchunks // target) * 64
    return split_len, -(-n_pad // split_len)


def _backward(ops, kp, blobs, src, x, v, n: int, spr: int, g4, input_grads: bool,
              scenes: int = 1):
    """K4w / K3w (K4ws / K3ws with ``scenes`` > 1: every scene's padded
    points, no input grads): (f32 grads of the packed leaves, dx, dv) from
    the cotangent g4 [4, n] (a strided view) of raw at the points of ``src``
    (("rays", ro, rd, z) or ("points", x)); dx and dv (of x [n, 3] and v)
    with ``input_grads`` only. A scene's columns: its views rounded up to
    whole tiles, spr columns each, so each scene's columns are the
    single-scene plan's."""
    dtype, W, Fp, Fv, ke, kv = _config(kp)
    dev = g4.device
    w, b = _blocks(kp, blobs)
    dense, nv = spr == 1, n // spr
    V = cols(-(-nv // scenes))  # a scene's views (rays) and columns
    C = V * spr
    N = scenes * C
    gemm = functools.partial(ops.gemm, scenes=scenes)
    blocks, nrows = fused_mlp.ws_rows(W, ke, kv)
    spans = {**blocks, **fused_mlp.chain_ws_rows(W, ke)}
    spans["gc"] = (spans["gc"][0], 8)
    ws = torch.empty(nrows, N, dtype=dtype, device=dev)
    rows = {k: ws[r0 : r0 + k_] for k, (r0, k_) in spans.items()}
    f32 = dict(dtype=torch.float32, device=dev)

    # the forward again, into the workspace rows
    rays = (src[1], src[2], src[3], spr) if src[0] == "rays" else None
    ops.embed(rows["e"], Fp, n, rays=rays, x=None if rays else src[1])
    rws = None
    if dense:
        ops.embed(rows["ev"], Fv, n, x=v)
        view = ("src", rows["ev"])
    else:
        rws = torch.empty(kv + W // 2, scenes * V, dtype=dtype, device=dev)
        view = ("add", _view_terms(ops, w, v, nv, Fv, kv, W, dtype, rws[:kv], scenes), spr)
    _layers(ops, w, b, rows, W, ke, kv, N, view, scenes)

    # the cotangent chain (nerf_tpu's _mlp_backward_math), each block's
    # unrounded f32 sums per tile of columns into the bias partials
    nbias = 9 * W + W // 2 + 4
    bpart = torch.empty(N // TILE, nbias, **f32)
    boff = {**{f"b{i}": i * W for i in range(8)}, "bf": 8 * W, "bv": 9 * W, "bout": 9 * W + W // 2}
    bs = lambda name, k: bpart[:, boff[name] : boff[name] + k]  # noqa: E731
    ops.gc(g4, n, rows["gc"], bs("bout", 4))
    gc4 = rows["gc"][:4]
    wout = kp["Wout"]
    wout_hv = F.pad(wout[..., : W // 2, :], (0, 4)).contiguous()  # rows of 8: a legal TMA stride
    wout_h7 = F.pad(wout[..., W // 2:, :], (0, 4)).contiguous()
    dhv32 = None if dense else torch.empty(W // 2, N, **f32)
    gemm(W // 2, N, [(wout_hv, 4, gc4)], mask=rows["hv"], out=rows["dhv"], out32=dhv32,
         bsum=bs("bv", W // 2))
    gemm(W, N, [(kp["Wvf"], W // 2, rows["dhv"])], out=rows["dfeat"], bsum=bs("bf", W))
    gemm(W, N, [(kp["Wf"], W, rows["dfeat"]), (wout_h7, 4, gc4)], mask=rows["h7"],
         out=rows["d7"], bsum=bs("b7", W))
    for i in range(7, 0, -1):
        gemm(W, N, [(kp[f"W{i}"], W, rows[f"d{i}"])], mask=rows[f"h{i - 1}"],
             out=rows[f"d{i - 1}"], bsum=bs(f"b{i - 1}", W))
    if not dense:
        ops.ray_sums(dhv32, nv, spr, rws[kv:])

    dx = dv = None
    if input_grads:
        if scenes > 1:
            raise ValueError("the stacked backward takes no input grads")
        ep, evd = 3 + 6 * Fp, 3 + 6 * Fv
        w05 = kp["W05e"]
        de = torch.empty(ep, N, **f32)
        ops.gemm(ep, N, [(w05[:, :W], W, rows["d0"]), (w05[:, W:], W, rows["d5"])], out32=de)
        dx = torch.empty(n, 3, **f32)
        ops.embed_bwd(x, n, Fp, de, dx)
        d_hv = rows["dhv"] if dense else rws[kv:]
        dev_ = torch.empty(evd, d_hv.shape[1], **f32)
        ops.gemm(evd, d_hv.shape[1], [(kp["Wve"], W // 2, d_hv)], out32=dev_)
        dv = torch.empty(nv, 3, **f32)
        ops.embed_bwd(v, nv, Fv, dev_, dv)

    # the weight grads over the rows (phase 3), then the bias partials' sums,
    # a set a scene, each scene's split as one scene's alone
    probs = _problems(W, ke, kv, dense)
    split_len, nsplit = _splits(dtype == torch.bfloat16, probs, C, ops.cluster_slots)
    _, grad_size = _grad_offsets(W, ke, kv)
    out = torch.empty(scenes, grad_size + nbias, **f32)
    ops.wgrad(ws, rws, probs, split_len, nsplit, grad_size, out, bpart, scenes)
    return fused_mlp._unpack_grads(out if scenes > 1 else out[0], W, Fp, Fv), dx, dv


def rays_planes_bwd(ops, kp, rays_o, rays_d, viewdirs, z_vals, g_planes,
                    blobs=None) -> Dict[str, torch.Tensor]:
    """K4w's launches: f32 grads of the packed leaves from the cotangent
    planes [4, R, S]."""
    R, S = z_vals.shape
    ro, rd, vd, z, g = (t.contiguous() for t in (rays_o, rays_d, viewdirs, z_vals, g_planes))
    grads, _, _ = _backward(ops, kp, blobs, ("rays", ro, rd, z), None, vd, R * S, S,
                            g.view(4, R * S), False)
    return grads


def points_bwd(ops, kp, x, v, g, spr: int, input_grads: bool, blobs=None):
    """K3w's launches: (f32 grads, dx [N, 3], dv [N/spr, 3]) from the
    cotangent g [N, 4] of raw; dx, dv None without ``input_grads``."""
    xc, vc, gc = x.contiguous(), v.contiguous(), g.contiguous()
    return _backward(ops, kp, blobs, ("points", xc), xc, vc, x.shape[0], spr, gc.T, input_grads)


# ------------------------------------------------ the stacked wide plans
#
# S nets of one shape (stacked packed leaves [S, ...]) in one set of
# launches: scene s's rays [s] of [S, R, ...] inputs (views of points: [s]
# of [S, P, 3] points and [S, P / spr, 3] directions) are zero-padded to
# cols(R) rays (views), so its columns are whole tiles after the scene
# before's, and each launch runs every scene on its own weights.


def _pad_scenes(ts, V: int, dim: int = 1):
    """Each [S, n, ...] tensor (``dim`` the n axis) zero-padded to V along
    ``dim``, contiguous."""
    return fused_mlp._padded(ts, V, dim)


def rays_planes_stacked_padded(ops, kp, ro, rd, vd, z, blobs=None) -> torch.Tensor:
    """K1ws's launches on padded inputs (rays [S, V, 3], depths [S, V, N],
    V a multiple of TILE): raw planes [4, S, V, N] float32."""
    S, V, N = z.shape
    out = torch.empty(4, S, V, N, dtype=torch.float32, device=z.device)
    flat = [t.flatten(0, 1) for t in (ro, rd, vd, z)]
    _forward(ops, kp, blobs, [(("rays", flat[0], flat[1], flat[3]), flat[2], S * V * N, N, 0)],
             out.view(4, S * V * N), S)
    return out


def rays_planes_stacked(ops, kp, rays_o, rays_d, viewdirs, z_vals, blobs=None) -> torch.Tensor:
    """K1ws's launches: raw planes [4, S, R, N] float32 of S scenes from
    stacked packed params, rays [S, R, 3] and depths [S, R, N]."""
    R = z_vals.shape[1]
    padded = _pad_scenes((rays_o, rays_d, viewdirs, z_vals), cols(R))
    return rays_planes_stacked_padded(ops, kp, *padded, blobs)[:, :, :R]


def rays_planes_stacked_bwd_padded(ops, kp, ro, rd, vd, z, g, blobs=None) -> Dict[str, torch.Tensor]:
    """K4ws's launches on padded inputs (as ``rays_planes_stacked_padded``'s,
    the cotangent planes g [4, S, V, N] contiguous, zero on padded rays)."""
    S, V, N = z.shape
    flat = [t.flatten(0, 1) for t in (ro, rd, vd, z)]
    grads, _, _ = _backward(ops, kp, blobs, ("rays", flat[0], flat[1], flat[3]), None, flat[2],
                            S * V * N, N, g.view(4, S * V * N), False, S)
    return grads


def rays_planes_stacked_bwd(ops, kp, rays_o, rays_d, viewdirs, z_vals, g_planes,
                            blobs=None) -> Dict[str, torch.Tensor]:
    """K4ws's launches: f32 grads of the stacked packed leaves (kp's [S, ...]
    shapes) from the cotangent planes [4, S, R, N]."""
    V = cols(z_vals.shape[1])
    (g,) = _pad_scenes((g_planes,), V, dim=2)  # padded rays: a zero cotangent
    return rays_planes_stacked_bwd_padded(
        ops, kp, *_pad_scenes((rays_o, rays_d, viewdirs, z_vals), V), g, blobs)


def points_raw_stacked(ops, kp, x, v, spr: int, blobs=None) -> torch.Tensor:
    """K2ws's launches: raw [S, P, 4] float32 of S scenes from stacked
    packed params at points x [S, P, 3], point p of scene s looking along
    v[s, p // spr]."""
    S, P, _ = x.shape
    V = cols(P // spr)
    (xp,), (vp,) = _pad_scenes((x,), V * spr), _pad_scenes((v,), V)
    out = torch.empty(S, V * spr, 4, dtype=torch.float32, device=x.device)
    n = S * V * spr
    _forward(ops, kp, blobs, [(("points", xp.view(n, 3)), vp.flatten(0, 1), n, spr, 0)],
             out.view(n, 4).T, S)
    return out[:, :P]


def points_stacked_bwd(ops, kp, x, v, g, spr: int, blobs=None) -> Dict[str, torch.Tensor]:
    """K3ws's launches: f32 grads of the stacked packed leaves from the
    cotangent g [S, P, 4] of raw (no input grads)."""
    S, P, _ = x.shape
    V = cols(P // spr)
    xp, gp = _pad_scenes((x, g), V * spr)  # padded points: a zero cotangent
    (vp,) = _pad_scenes((v,), V)
    n = S * V * spr
    xf = xp.view(n, 3)
    grads, _, _ = _backward(ops, kp, blobs, ("points", xf), xf, vp.flatten(0, 1), n, spr,
                            gp.view(n, 4).T, False, S)
    return grads


def stacked_workspace_bytes(W: int, Fp: int, Fv: int, n_scenes: int, views_per_scene: int,
                            spr: int, bf16: bool = True) -> int:
    """Bytes of device memory that one stacked wide backward (K4ws, K3ws,
    K6ws's second half) allocates for S scenes of ``views_per_scene`` rays
    (views) of spr points (1: a direction per point): the workspace rows,
    the per-ray rows and the f32 d_hv rows and view terms, the bias and
    weight-grad partials and the grads."""
    ke, kv = fused_mlp.embed_pad(Fp, Fv)
    esz = 2 if bf16 else 4
    V = cols(views_per_scene)
    N = n_scenes * V * spr
    nrows = fused_mlp.ws_rows(W, ke, kv)[1]
    nbias = 9 * W + W // 2 + 4
    _, grad_size = _grad_offsets(W, ke, kv)
    probs = _problems(W, ke, kv, spr == 1)
    _, nsplit = _splits(bf16, probs, V * spr)
    total = nrows * N * esz + (N // TILE) * nbias * 4
    total += n_scenes * (nsplit + 1) * grad_size * 4 + n_scenes * nbias * 4
    if spr > 1:
        total += n_scenes * V * ((kv + W // 2) * esz + (W // 2) * 4) + (W // 2) * N * 4
    return total


def _ops(kp, like: torch.Tensor) -> Ops:
    fused_mlp._kernel_config(kp, like, tile=False)
    return Ops(kp["W1"].dtype, like.device)


def fused_rays_planes_wide(kp, rays_o, rays_d, viewdirs, z_vals, blobs=None) -> torch.Tensor:
    """K1w on CUDA tensors: ``rays_planes``' launches (``launches`` counts
    the calls)."""
    out = rays_planes(_ops(kp, z_vals), kp, rays_o, rays_d, viewdirs, z_vals, blobs)
    fused_rays_planes_wide.launches += 1
    return out


fused_rays_planes_wide.launches = 0


def fused_points_wide(kp, x, v, spr: int, blobs=None) -> torch.Tensor:
    """K2w on CUDA tensors (``launches`` counts the calls)."""
    out = points_raw(_ops(kp, x), kp, x, v, spr, blobs)
    fused_points_wide.launches += 1
    return out


fused_points_wide.launches = 0


def fused_rays_planes_wide_bwd(kp, rays_o, rays_d, viewdirs, z_vals, g_planes,
                               blobs=None) -> Dict[str, torch.Tensor]:
    """K4w on CUDA tensors (``launches`` counts the calls)."""
    grads = rays_planes_bwd(_ops(kp, z_vals), kp, rays_o, rays_d, viewdirs, z_vals, g_planes,
                            blobs)
    fused_rays_planes_wide_bwd.launches += 1
    return grads


fused_rays_planes_wide_bwd.launches = 0


def fused_points_wide_bwd(kp, x, v, g, spr: int, input_grads: bool = True, blobs=None):
    """K3w on CUDA tensors (``launches`` counts the calls)."""
    out = points_bwd(_ops(kp, x), kp, x, v, g, spr, input_grads, blobs)
    fused_points_wide_bwd.launches += 1
    return out


fused_points_wide_bwd.launches = 0


def fused_rays_planes_wide_stacked(kp, rays_o, rays_d, viewdirs, z_vals,
                                   blobs=None) -> torch.Tensor:
    """K1ws on CUDA tensors: ``rays_planes_stacked``' launches, one set for
    every scene (``launches`` counts the calls)."""
    out = rays_planes_stacked(_ops(kp, z_vals), kp, rays_o, rays_d, viewdirs, z_vals, blobs)
    fused_rays_planes_wide_stacked.launches += 1
    return out


fused_rays_planes_wide_stacked.launches = 0


def fused_rays_planes_wide_stacked_bwd(kp, rays_o, rays_d, viewdirs, z_vals, g_planes,
                                       blobs=None) -> Dict[str, torch.Tensor]:
    """K4ws on CUDA tensors (``launches`` counts the calls)."""
    grads = rays_planes_stacked_bwd(_ops(kp, z_vals), kp, rays_o, rays_d, viewdirs, z_vals,
                                    g_planes, blobs)
    fused_rays_planes_wide_stacked_bwd.launches += 1
    return grads


fused_rays_planes_wide_stacked_bwd.launches = 0


def fused_points_wide_stacked(kp, x, v, spr: int, blobs=None) -> torch.Tensor:
    """K2ws on CUDA tensors (``launches`` counts the calls)."""
    out = points_raw_stacked(_ops(kp, x), kp, x, v, spr, blobs)
    fused_points_wide_stacked.launches += 1
    return out


fused_points_wide_stacked.launches = 0


def fused_points_wide_stacked_bwd(kp, x, v, g, spr: int, blobs=None) -> Dict[str, torch.Tensor]:
    """K3ws on CUDA tensors (``launches`` counts the calls)."""
    grads = points_stacked_bwd(_ops(kp, x), kp, x, v, g, spr, blobs)
    fused_points_wide_stacked_bwd.launches += 1
    return grads


fused_points_wide_stacked_bwd.launches = 0
