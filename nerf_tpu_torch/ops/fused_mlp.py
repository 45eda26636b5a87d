"""Fused posenc + NeRF MLP, forward and backward, in two input modes.

Counterpart of nerf_tpu/ops/fused_mlp.py:
- raygen mode, ``fused_query_rays_planes``: rays ``[R, 3]`` and depths
  ``z [R, S]`` in, raw (r, g, b, sigma) as four ``[R, S]`` planes out. The
  points ``x = o + d·z``, both embeddings and all activations exist only
  inside the kernels: K1 (``csrc/fused_mlp_fwd.cu``) computes the planes, K4
  (``csrc/fused_mlp_bwd.cu``) the weight grads from their cotangent; rays
  and depths get no gradient (ref run_nerf.py:394). The renderer takes it
  when S % 8 == 0;
- points-in mode, ``fused_query``: points ``[R, S, 3]`` and view directions
  ``[R, 3]`` in, raw ``[R, S, 4]`` out. K2 (``nerf_fused_mlp_fwd_points`` in
  the forward library) computes it, K3 (``nerf_fused_mlp_bwd_points``) the
  weight grads and, with ``input_grads``, the points' and directions' grads
  through the posenc trig. ``query_raw`` takes it at any other S.

The pieces:
- ``pack_params``: the kernels' weight layout, as nerf_tpu's ``pack_params``
  builds it (rows of the embedding weights permuted to
  ``[x | sin f-major | cos]``, layer 0 and the skip's embedding half merged
  into ``W05e``, rgb and alpha merged into ``Wout``, f32 biases). It is
  differentiable, so only the kernels need a hand-written backward;
  ``packed_params`` keeps a detached packing and the kernel's flat buffers
  on the module for serving;
- ``fused_rays_planes_reference`` / ``fused_rays_planes_bwd_reference`` and
  ``fused_points_reference`` / ``fused_points_bwd_reference``: the plain
  PyTorch versions of K1, K4, K2 and K3 (one forward and one backward,
  ``_forward`` / ``_backward``, fed from rays or from points);
- ``fused_rays_planes`` / ``fused_rays_planes_bwd`` / ``fused_points`` /
  ``fused_points_bwd``: the wrappers. A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises: the W <= 256 tile's
  where ``tile_supports``, else (``is_wide``) the wide family's K1w-K4w
  (ops/fused_mlp_wide.py);
- ``fused_query_rays_planes`` and ``fused_query``: the entries the renderer
  calls; under autograd they run ``_FusedRaysPlanes`` (K1 forward, K4
  backward) and ``_FusedPoints`` (K2 forward, K3 backward);
- ``bwd_recompute_reference`` / ``bwd_recompute`` and ``bwd_recompute_rays``:
  the bf16 backward's first launch, its recompute on K1's tile, alone: the
  workspace rows and relu mask words it writes (``unpack_mask_bits`` decodes
  them), for checks, with ``recompute_layers_reference`` to hold each layer
  to its plain version on the kernel's own inputs; K4 and K3 launch it
  themselves;
- ``bwd_chain_reference`` / ``bwd_chain`` and ``bwd_chain_rays``: the bf16
  backward's first two launches, the recompute and the cotangent chain
  (``bwd_chain_sm90``), alone: the chain's workspace rows, its f32 d_hv rows,
  its bias partials and the input grads, with ``chain_layers_reference`` to
  hold each block to its one product on the kernel's own inputs. The plain
  backward (``_backward``) takes its cotangents from the same code;
- the stacked (multi-scene) pairs, ``fused_rays_planes_stacked`` /
  ``fused_rays_planes_stacked_bwd`` and ``fused_query_rays_planes_stacked``,
  and ``fused_points_stacked`` / ``fused_points_stacked_bwd`` and
  ``fused_query_stacked``: S nets of one shape as leaves with a leading
  scene axis, one launch of K1 and of K4 (K2 and K3) for every scene's rays
  (points) (``nerf_fused_mlp_fwd_stacked``, ``nerf_fused_mlp_bwd_stacked``,
  ``nerf_fused_mlp_fwd_points_stacked``,
  ``nerf_fused_mlp_bwd_points_stacked``), each tile on its own scene's
  weights, or where ``is_wide`` the wide family's stacked plans (K1ws-K4ws,
  ops/fused_mlp_wide.py); their plain versions apply K1's and K4's (K2's and
  K3's) scene by scene.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP, round_to
from nerf_tpu_torch.ops import _build

DEPTH = 8
SKIP = 4  # input re-concatenated after trunk layer 4 -> layer 5 input
KE, KV = 64, 32  # the tile's padded embedding widths (csrc/fused_mlp_common.cuh)
KERNEL_WIDTHS = (128, 256)  # the widths the tile (csrc/fwd_tile_sm90.cuh) is built for
FWD_TILE = 128  # points of a bf16 forward tile (csrc/fwd_tile_sm90.cuh)
# the packed leaves, in the order _FusedRaysPlanes takes them
KP_NAMES = (
    ("W05e", "b0")
    + tuple(n for i in range(1, DEPTH) for n in (f"W{i}", f"b{i}"))
    + ("Wf", "bf", "Wvf", "Wve", "bv", "Wout", "bout")
)


def supports(cfg: MLPConfig, pe_pts: PosEncConfig, pe_views) -> bool:
    """The architecture family the single-scene kernels compute: nerf_tpu's
    guard (nerf_tpu/ops/fused_mlp.py::supports). ``tile_supports`` says
    whether the W <= 256 tile or the wide family (ops/fused_mlp_wide.py)
    runs a configuration."""
    return (
        cfg.depth == DEPTH
        and cfg.skips == (SKIP,)
        and cfg.use_viewdirs
        and cfg.width % 128 == 0
        and pe_views is not None
        and pe_pts.include_input
        and pe_pts.log_sampling
        and pe_views.include_input
        and pe_views.log_sampling
        and pe_pts.num_freqs > 0
        and pe_views.num_freqs > 0
    )


def tile_supports(width: int, num_freqs_pts: int, num_freqs_views: int) -> bool:
    """Whether the W <= 256 tile (csrc/fwd_tile_sm90.cuh and the kernels
    built on it) is built for a width and octave counts: W in
    KERNEL_WIDTHS, at most KE point and KV view embedding columns (10 and 4
    octaves). The rest of ``supports``' family runs the wide kernels."""
    return (width in KERNEL_WIDTHS and 3 + 6 * num_freqs_pts <= KE
            and 3 + 6 * num_freqs_views <= KV)


def supports_stacked(cfg: MLPConfig, pe_pts: PosEncConfig, pe_views) -> bool:
    """The stacked (multi-scene) kernels' guard: ``supports``, as nerf_tpu
    runs its kernels under its vmap over the scenes wherever they run for
    one. The tile's stacked launches take ``tile_supports``' part, the wide
    family's stacked plans (ops/fused_mlp_wide.py) the rest."""
    return supports(cfg, pe_pts, pe_views)


def embed_pad(num_freqs_pts: int, num_freqs_views: int) -> Tuple[int, int]:
    """(KE, KV): the kernels' padded embedding widths at a configuration's
    octaves, 3 + 6F rounded up to 64 (points) and 32 (views): the tile's
    64 and 32 wherever the tile runs."""
    return -(-(3 + 6 * num_freqs_pts) // 64) * 64, -(-(3 + 6 * num_freqs_views) // 32) * 32


def is_wide(kp) -> bool:
    """Whether packed params are of a configuration the wide family runs."""
    return not tile_supports(kp["W1"].shape[-1], *_num_freqs(kp))


def flops_per_point(cfg: MLPConfig, pe_pts: PosEncConfig, pe_views: PosEncConfig) -> int:
    """Multiply-add FLOP of the MLP per sample point, as the architecture
    needs them (no padding, no zero blocks of the merged head): trunk
    layers 0..7, the skip's extra input, feature, alpha, view and rgb
    layers. 1,186,816 at 8x256 with 10/4 octaves. (nerf_tpu's
    utils/profiler.py mlp_flops_per_point counts 6 trunk WxW layers, not 7.)"""
    W, ep, ev = cfg.width, pe_pts.out_dim, pe_views.out_dim
    macs = ep * W + (DEPTH - 1) * W * W + ep * W  # trunk + skip input
    macs += W * W + W + (W + ev) * (W // 2) + (W // 2) * 3  # heads
    return 2 * macs


def bwd_flops(cfg: MLPConfig, pe_pts: PosEncConfig, pe_views: PosEncConfig,
              n_rays: int, n_samples: int, input_grads: bool = False) -> int:
    """FLOP of K4 or K3 for one call, as ``_mlp_backward_math`` needs them:
    the forward recompute without the rgb/alpha head, the activation
    cotangents and the weight grads, per point; dWve per ray (per point in
    the dense mode: ``n_samples=1``). 3,484,416 per point at 8x256 with 10/4
    octaves, plus 6,912 per ray. ``input_grads`` adds d_e = [d0 | d5] W05eᵀ
    per point and d_ev = d_hv Wveᵀ per ray (the trig is not counted)."""
    W, ep, ev = cfg.width, pe_pts.out_dim, pe_views.out_dim
    recompute = 2 * ep * W + DEPTH * W * W + (W + ev) * (W // 2)  # W05e, W1..7 + Wf, view
    head = (W // 2 + W) * 4 + 4 * (W // 2) + 4 * W  # dWout, d_hv, d_h7 from Wout
    view = 2 * W * (W // 2)  # dWvf, d_feat
    trunk = 2 * DEPTH * W * W  # dWf + d_h7 (Wf), dW_i + d_h (W1..W7)
    macs_pt = recompute + head + view + trunk + ep * 2 * W  # + dW05e
    macs_ray = ev * (W // 2)
    if input_grads:
        macs_pt += ep * 2 * W
        macs_ray *= 2
    return 2 * (n_rays * n_samples * macs_pt + n_rays * macs_ray)


def wgrad_flops(cfg: MLPConfig, pe_pts: PosEncConfig, pe_views: PosEncConfig,
                n_rays: int, n_samples: int) -> int:
    """FLOP of the backward's weight-grad phase (``wgrad_bf16`` in
    csrc/fused_mlp_bwd.cu) for one call, as the architecture needs them:
    dW05e, dW1..dW7, dWf, dWvf and dWout per point, dWve per ray (per point
    in the dense mode: ``n_samples=1``). 1,181,696 per point at 8x256 with
    10/4 octaves, plus 6,912 per ray."""
    W, ep, ev = cfg.width, pe_pts.out_dim, pe_views.out_dim
    macs_pt = ep * 2 * W + DEPTH * W * W + W * (W // 2) + (3 * W // 2) * 4
    return 2 * (n_rays * n_samples * macs_pt + n_rays * ev * (W // 2))


def _ke(cfg: MLPConfig) -> int:
    """KE of a configuration, from its point embedding's 3 + 6F columns
    (``cfg.input_ch``)."""
    return embed_pad((cfg.input_ch - 3) // 6, 1)[0]


def wgrad_bytes_per_point(cfg: MLPConfig) -> int:
    """Bytes of the bf16 workspace that the weight-grad phase must read per
    point in ray mode, each row once (WsRows in csrc/fused_mlp_bwd.cu): the
    padded embedding e (KE rows, ``_ke``: the tile's 64 at 10 octaves),
    h0..h7, feat, hv, the 8 rows kept for the cotangent gc, d0..d7, d_feat
    and d_hv. 9,872 at 8x256."""
    W = cfg.width
    return 2 * (_ke(cfg) + 2 * (DEPTH * W + W + W // 2) + 8)


def bwd_tile_flops(cfg: MLPConfig, pe_pts: PosEncConfig, pe_views: PosEncConfig,
                   n_rays: int, n_samples: int, input_grads: bool = False) -> int:
    """FLOP of the backward's phase 1 (``bwd_recompute_sm90`` and
    ``bwd_chain_sm90`` in csrc/fused_mlp_bwd.cu) for one call: ``bwd_flops``
    less the weight grads (``wgrad_flops``), i.e. the forward recompute
    without the rgb/alpha head and the activation cotangents, per point.
    2,302,720 per point at 8x256 with 10/4 octaves. ``input_grads`` adds d_e
    per point and d_ev per ray (which phase 2 computes where a ray has its
    own direction)."""
    return (bwd_flops(cfg, pe_pts, pe_views, n_rays, n_samples, input_grads)
            - wgrad_flops(cfg, pe_pts, pe_views, n_rays, n_samples))


def mask_bytes_per_point(cfg: MLPConfig) -> int:
    """Bytes of the relu masks of h0..h7 and hv as bits (MaskRows in
    csrc/fused_mlp_bwd.cu): 272 at 8x256."""
    return (DEPTH * cfg.width + cfg.width // 2) // 8


def recompute_flops(cfg: MLPConfig, pe_pts: PosEncConfig, pe_views: PosEncConfig,
                    n_rays: int, n_samples: int) -> int:
    """FLOP of the backward's recompute launch (``bwd_recompute_sm90`` in
    csrc/fused_mlp_bwd.cu) for one call: the forward without the rgb/alpha
    head (W05e's two halves, W1..W7, Wf, and the view layer over
    [feat | ev]), per point. 1,185,536 at 8x256 with 10/4 octaves."""
    W, ep, ev = cfg.width, pe_pts.out_dim, pe_views.out_dim
    return 2 * n_rays * n_samples * (2 * ep * W + DEPTH * W * W + (W + ev) * (W // 2))


def recompute_bytes_per_point(cfg: MLPConfig) -> int:
    """Bytes that the recompute launch must move per point in ray mode with
    a view direction per ray (K4's training call), each once: the bf16
    workspace rows it writes (the padded embedding e, KE rows as in
    ``wgrad_bytes_per_point``, h0..h7, feat, hv), the mask words and the
    depth z read. 5,268 at 8x256. The per-ray inputs and the weights are
    counted apart."""
    W = cfg.width
    return 2 * (_ke(cfg) + DEPTH * W + W + W // 2) + mask_bytes_per_point(cfg) + 4


def chain_flops(cfg: MLPConfig, pe_pts: PosEncConfig, pe_views: PosEncConfig,
                n_rays: int, n_samples: int, input_grads: bool = False) -> int:
    """FLOP of the backward's cotangent chain (``bwd_chain_sm90``) for one
    call: phase 1 less the recompute. 1,117,184 per point at 8x256 with
    10/4 octaves; ``input_grads`` as in ``bwd_tile_flops``."""
    return (bwd_tile_flops(cfg, pe_pts, pe_views, n_rays, n_samples, input_grads)
            - recompute_flops(cfg, pe_pts, pe_views, n_rays, n_samples))


def chain_bytes_per_point(cfg: MLPConfig) -> int:
    """Bytes that the chain must move per point in K4's training call, each
    once: the bf16 workspace rows it writes (4 of gc's 8 rows, d0..d7,
    d_feat, d_hv), the f32 d_hv rows for phase 2, the mask words and the
    cotangent g (4 f32) read. 5,672 at 8x256. The per-ray inputs, the
    weights and the tiles' bias sums are counted apart."""
    W = cfg.width
    rows = 4 + DEPTH * W + W + W // 2
    return 2 * rows + 4 * (W // 2) + mask_bytes_per_point(cfg) + 4 * 4


def bwd_tile_bytes_per_point(cfg: MLPConfig) -> int:
    """Bytes that the backward's phase 1, the recompute and the chain, must
    move per point in ray mode with a view direction per ray (K4's training
    call), each once: every workspace row it writes (``wgrad_bytes_per_point``
    less the 4 of gc's 8 rows that phase 1 leaves unwritten), the f32 d_hv
    rows for phase 2, the cotangent g (4 f32) and the depth z read, and the
    mask words that the recompute writes and the chain reads. 10,940 at
    8x256. The per-ray inputs, the weights and the tiles' bias sums are
    counted apart."""
    return recompute_bytes_per_point(cfg) + chain_bytes_per_point(cfg)


def fwd_weight_bytes_per_tile(cfg: MLPConfig) -> int:
    """Bytes of the bf16 weight blob (``kernel_blobs(kp)[0]``, Layout<W> in
    csrc/fused_mlp_common.cuh) that the bf16 forward of K1 and K2
    (csrc/fwd_tile_sm90.cuh) reads from L2 once per tile of ``FWD_TILE``
    points: W05eᵀ, W1ᵀ..W7ᵀ, Wfᵀ, Wvfᵀ, Wveᵀ (embedding K padded to 64 / 32)
    and Wout [3W/2, 4]. 1,190,912 at 8x256, 316,928 at 8x128."""
    W = cfg.width
    return 2 * (2 * W * KE + DEPTH * W * W + (W // 2) * W + (W // 2) * KV + (3 * W // 2) * 4)


def _reorder_emb_rows(w: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Rows in embedding order (x, sin f0, cos f0, sin f1, ...) -> kernel
    order [x (3) | sin, f-major (3F) | cos (3F)], along the second-to-last
    axis (``w`` [..., rows, out])."""
    lead, n = w.shape[:-2], w.shape[-1]
    rest = w[..., 3 : 3 + 6 * num_freqs, :].reshape(*lead, num_freqs, 2, 3, n)
    ws = rest[..., 0, :, :].reshape(*lead, 3 * num_freqs, n)
    wc = rest[..., 1, :, :].reshape(*lead, 3 * num_freqs, n)
    return torch.cat([w[..., :3, :], ws, wc], -2)


def pack_params(
    mlp: NeRFMLP, pe_pts: PosEncConfig, pe_views: PosEncConfig, dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """The module's weights in the kernel's layout, ``[in, out]`` like
    nerf_tpu's pack_params: W05e [ep, 2W], W1..W7 / Wf [W, W], Wvf [W, W/2],
    Wve [ev, W/2], Wout [3W/2, 4] in ``dtype``; biases [1, out] float32.
    Differentiable: under autograd the grads of the packed leaves flow back
    through the casts, reorders and concatenations to the parameters. A
    stacked net (render/network.py's StackedNeRFMLP, parameters [S, ...])
    packs to leaves with the same leading scene axis, each scene's slice its
    own net's packing."""
    W = mlp.cfg.width
    ep = 3 + 6 * pe_pts.num_freqs
    trunk = mlp.pts_linears
    kp = {}
    w0e = _reorder_emb_rows(trunk[0].weight.mT, pe_pts.num_freqs)
    for i in range(DEPTH):
        w = trunk[i].weight.mT  # [..., in, out]
        if i == SKIP + 1:
            w5e = _reorder_emb_rows(w[..., :ep, :], pe_pts.num_freqs)
            kp["W05e"] = torch.cat([w0e, w5e], -1).to(dtype)
            kp[f"W{i}"] = w[..., ep:, :].to(dtype)
        elif i > 0:
            kp[f"W{i}"] = w.to(dtype)
        kp[f"b{i}"] = trunk[i].bias.float().unsqueeze(-2)
    kp["Wf"] = mlp.feature_linear.weight.mT.to(dtype)
    kp["bf"] = mlp.feature_linear.bias.float().unsqueeze(-2)
    wv = mlp.views_linears[0].weight.mT  # [..., W + ev, W/2], input order cat([feature, v_emb])
    kp["Wvf"] = wv[..., :W, :].to(dtype)
    kp["Wve"] = _reorder_emb_rows(wv[..., W:, :], pe_views.num_freqs).to(dtype)
    kp["bv"] = mlp.views_linears[0].bias.float().unsqueeze(-2)
    wr = mlp.rgb_linear.weight.mT  # [..., W/2, 3]
    wa = mlp.alpha_linear.weight.mT  # [..., W, 1]
    kp["Wout"] = torch.cat(
        [F.pad(wr, (0, 1)), F.pad(wa, (3, 0))], -2
    ).to(dtype)  # rows: hv -> rgb, h7 -> alpha
    kp["bout"] = torch.cat([mlp.rgb_linear.bias, mlp.alpha_linear.bias], -1).float().unsqueeze(-2)
    return {k: v.contiguous() for k, v in kp.items()}


def _num_freqs(kp) -> Tuple[int, int]:
    return (kp["W05e"].shape[-2] - 3) // 6, (kp["Wve"].shape[-2] - 3) // 6


def _phases(x: torch.Tensor, num_freqs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x·2^f [N, 3F] f-major, the scales 2^f [F]) for x [N, 3]."""
    scale = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    return (x[:, None, :] * scale[:, None]).reshape(x.shape[0], 3 * num_freqs), scale


def _embed(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[N, 3] -> [N, 3 + 6F] in kernel order [x | sin f-major | cos]."""
    xb, _ = _phases(x, num_freqs)
    return torch.cat([x, torch.sin(xb), torch.cos(xb)], -1)


def _embed_backward(d_e: torch.Tensor, x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """dx [N, 3] from the cotangent d_e [N, >= 3 + 6F] of ``_embed(x)``:
    the identity columns plus Σ_f 2^f (d_sin·cos − d_cos·sin) at the f32
    phases x·2^f (nerf_tpu/ops/fused_mlp.py:526-532, :558-564)."""
    f3 = 3 * num_freqs
    xb, scale = _phases(x, num_freqs)
    d_xb = d_e[:, 3 : 3 + f3] * torch.cos(xb) - d_e[:, 3 + f3 : 3 + 2 * f3] * torch.sin(xb)
    return d_e[:, :3] + (d_xb.reshape(-1, num_freqs, 3) * scale[:, None]).sum(1)


def _ray_points(rays_o, rays_d, z_vals) -> torch.Tensor:
    """x = o + d·z [R*S, 3], a separate multiply and add as in K1."""
    R, S = z_vals.shape
    return (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]).reshape(R * S, 3)


class _Fwd(NamedTuple):
    e: torch.Tensor  # rounded point embedding [N, ep]
    ev: torch.Tensor  # rounded view embedding [N/spr, ev]
    acts: List[torch.Tensor]  # rounded h0..h6 (with keep_acts)
    h7: torch.Tensor
    feat: torch.Tensor
    hv: torch.Tensor
    out: torch.Tensor  # raw [N, 4]


def _forward(kp: Dict[str, torch.Tensor], x: torch.Tensor, v: torch.Tensor, spr: int,
             keep_acts: bool = False) -> _Fwd:
    """The kernels' forward from points x [N, 3] and view directions
    v [N/spr, 3] (point p looks along v[p // spr]), keeping the trunk's
    activations for the backward with ``keep_acts``. Mirrors nerf_tpu's _trunk_forward/_head_forward: operands in the
    packed dtype (bf16 rounding emulated, see models/nerf_mlp.py), f32 sums,
    the activations rounded to the compute dtype before each matmul."""
    dtype = kp["W1"].dtype
    c = lambda t: round_to(t, dtype)  # noqa: E731
    w = lambda name: kp[name].float()  # noqa: E731
    Fp, Fv = _num_freqs(kp)
    W = kp["W1"].shape[0]
    e = c(_embed(x, Fp))
    ev = c(_embed(v, Fv))
    z05 = e @ w("W05e")  # layer-0 and skip contributions in one product
    h = torch.relu(z05[:, :W] + kp["b0"])
    acts = []
    for i in range(1, DEPTH):
        hc = c(h)
        if keep_acts:
            acts.append(hc)
        z = hc @ w(f"W{i}") + kp[f"b{i}"]
        if i == SKIP + 1:
            z = z + z05[:, W:]
        h = torch.relu(z)
    hc = c(h)
    feat = hc @ w("Wf") + kp["bf"]
    ev_contrib = (ev @ w("Wve")).repeat_interleave(spr, dim=0)  # per view -> per point
    hv = torch.relu(c(feat) @ w("Wvf") + ev_contrib + kp["bv"])
    hw = W // 2
    out = c(hv) @ w("Wout")[:hw] + hc @ w("Wout")[hw:] + kp["bout"]
    return _Fwd(e, ev, acts, h, feat, hv, out)


def ws_rows(W: int, ke: int = KE, kv: int = KV) -> Tuple[Dict[str, Tuple[int, int]], int]:
    """((first row, rows) of each of the recompute's blocks, the row count)
    of the backward's bf16 workspace (WsRows in csrc/fused_mlp_bwd.cu, at
    padded embedding widths ke and kv: the tile's, or ``embed_pad``'s for
    the wide family; the view embedding's block is written only with a
    direction per point)."""
    gc = ke + DEPTH * W + W + W // 2
    ev = gc + 8 + DEPTH * W + W + W // 2
    blocks = {"e": (0, ke), **{f"h{i}": (ke + i * W, W) for i in range(DEPTH)},
              "feat": (ke + DEPTH * W, W), "hv": (ke + DEPTH * W + W, W // 2), "ev": (ev, kv)}
    return blocks, ev + kv


def mask_rows(W: int) -> int:
    """Rows of the mask words (MaskRows in csrc/fused_mlp_bwd.cu): W/32 a
    layer for h0..h7, then W/64 for hv."""
    return DEPTH * (W // 32) + W // 64


def pack_mask_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [N, n] -> int32 words [ceil(n/32), N], the kernel's layout: bit
    b of word k is feature 32k + b (a u32 read as int32)."""
    N, n = bits.shape
    b = F.pad(bits.to(torch.int64), (0, -n % 32)).reshape(N, -1, 32)
    words = (b << torch.arange(32, dtype=torch.int64, device=bits.device)).sum(-1).T
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32).contiguous()


def unpack_mask_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32 words [k, N] (``pack_mask_bits``' layout) -> bool [N, n], the
    first n features."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.T[:, :, None] >> shifts) & 1  # [N, k, 32]
    return bits.reshape(words.shape[1], -1)[:, :n].bool()


class Recompute(NamedTuple):
    rows: Dict[str, torch.Tensor]  # workspace rows by block (ws_rows): [features, points]
    masks: torch.Tensor  # int32 [mask_rows(W), points]: h0..h7's words, then hv's
    raw: Optional[torch.Tensor]  # [points, 4]


def bwd_recompute_reference(kp: Dict[str, torch.Tensor], x: torch.Tensor, v: torch.Tensor,
                            spr: int) -> Recompute:
    """Plain PyTorch version of the bf16 backward's recompute launch
    (``bwd_recompute_sm90``) from points x [N, 3] and directions v [N/spr,
    3]: the workspace rows it writes, rounded as the kernel rounds them (the
    padded embeddings e and ev, ev per direction; h0..h7, feat and hv), the
    relu masks of h0..h7 and hv as mask words, and raw. The rows are
    ``_forward``'s, so the masks are those the forward's activations give."""
    dtype = kp["W1"].dtype
    c = lambda t: round_to(t, dtype)  # noqa: E731
    ke, kv = embed_pad(*_num_freqs(kp))
    fw = _forward(kp, x, v, spr, keep_acts=True)
    hs = fw.acts + [c(fw.h7)]
    hv = c(fw.hv)
    rows = {"e": F.pad(fw.e, (0, ke - fw.e.shape[1])).T,
            "ev": F.pad(fw.ev, (0, kv - fw.ev.shape[1])).T,
            **{f"h{i}": h.T for i, h in enumerate(hs)}, "feat": c(fw.feat).T, "hv": hv.T}
    masks = torch.cat([pack_mask_bits(h > 0) for h in hs + [hv]], 0)
    return Recompute({k: t.contiguous() for k, t in rows.items()}, masks, fw.out)


def recompute_layers_reference(kp: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
                               x: torch.Tensor, v: torch.Tensor, spr: int) -> Dict[str, torch.Tensor]:
    """Each workspace block of ``bwd_recompute_reference`` computed by its
    one layer from the blocks it reads in ``rows`` (a recompute's, columns
    beyond x's N ignored; the view embedding's own where ``rows`` has none),
    not from the reference's own chain: a kernel's rows then differ from
    these by that layer's rounding alone. ``rows`` = the reference's gives
    the reference's rows."""
    dtype = kp["W1"].dtype
    c = lambda t: round_to(t, dtype)  # noqa: E731
    w = lambda name: kp[name].float()  # noqa: E731
    Fp, Fv = _num_freqs(kp)
    W, n = kp["W1"].shape[0], x.shape[0]
    ke, kv = kp["W05e"].shape[0], kp["Wve"].shape[0]
    ke_pad, kv_pad = embed_pad(Fp, Fv)
    inp = lambda name: rows[name][:, :n].T.float().contiguous()  # noqa: E731
    out = {"e": F.pad(c(_embed(x, Fp)), (0, ke_pad - ke)).T,
           "ev": F.pad(c(_embed(v, Fv)), (0, kv_pad - kv)).T}
    z05 = inp("e")[:, :ke] @ w("W05e")
    out["h0"] = c(torch.relu(z05[:, :W] + kp["b0"])).T
    for i in range(1, DEPTH):
        z = inp(f"h{i - 1}") @ w(f"W{i}") + kp[f"b{i}"]
        out[f"h{i}"] = c(torch.relu(z + z05[:, W:] if i == SKIP + 1 else z)).T
    out["feat"] = c(inp(f"h{DEPTH - 1}") @ w("Wf") + kp["bf"]).T
    ev = inp("ev")[: n // spr, :kv] if "ev" in rows else out["ev"][:kv].T
    ev_contrib = (ev @ w("Wve")).repeat_interleave(spr, dim=0)
    out["hv"] = c(torch.relu(inp("feat") @ w("Wvf") + ev_contrib + kp["bv"])).T
    return {k: t.contiguous() for k, t in out.items()}


def fused_rays_planes_reference(
    kp: Dict[str, torch.Tensor],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of K1: raw planes [4, R, S] float32 (see
    ``_forward``)."""
    R, S = z_vals.shape
    out = _forward(kp, _ray_points(rays_o, rays_d, z_vals), viewdirs, S).out
    return out.T.reshape(4, R, S)


def fused_points_reference(
    kp: Dict[str, torch.Tensor], x: torch.Tensor, v: torch.Tensor, spr: int
) -> torch.Tensor:
    """Plain PyTorch version of K2: raw [N, 4] float32 at points x [N, 3],
    point p looking along v[p // spr] (see ``_forward``)."""
    return _forward(kp, x, v, spr).out


def kernel_blobs(kp: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack ``kp`` into the kernel's two flat buffers (Layout in
    csrc/fused_mlp_common.cuh): weights as ``[out, in]`` rows with the
    embedding K padded to ``embed_pad``'s widths (the tile's 64 / 32), then
    Wout as is; biases concatenated in f32. Stacked leaves ([S, ...]) give
    each scene's blobs one after another, as the stacked K1 and K4 take
    them."""
    lead = kp["W1"].shape[:-2]
    ke, kv = embed_pad(*_num_freqs(kp))

    def rows(name, k_pad=None):
        wt = kp[name].mT
        if k_pad is not None:
            wt = F.pad(wt, (0, k_pad - wt.shape[-1]))
        return wt.reshape(*lead, -1)

    wblob = torch.cat(
        [rows("W05e", ke)]
        + [rows(f"W{i}") for i in range(1, DEPTH)]
        + [rows("Wf"), rows("Wvf"), rows("Wve", kv), kp["Wout"].reshape(*lead, -1)], -1
    )
    bblob = torch.cat(
        [kp[f"b{i}"].reshape(*lead, -1) for i in range(DEPTH)]
        + [kp[n].reshape(*lead, -1) for n in ("bf", "bv", "bout")], -1
    )
    return wblob.reshape(-1).contiguous(), bblob.reshape(-1).contiguous()


def _check_rays(rays_o, rays_d, viewdirs, z_vals):
    R, S = z_vals.shape
    for name, t, shape in (
        ("rays_o", rays_o, (R, 3)),
        ("rays_d", rays_d, (R, 3)),
        ("viewdirs", viewdirs, (R, 3)),
        ("z_vals", z_vals, (R, S)),
    ):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != z_vals.device:
            raise ValueError(f"{name} is on {t.device}, z_vals on {z_vals.device}")


def packed_params(
    mlp: NeRFMLP, pe_pts: PosEncConfig, pe_views: PosEncConfig, dtype: torch.dtype
):
    """``(pack_params(...), kernel_blobs(...) or None on the CPU)`` for
    ``mlp``, kept on the module and rebuilt only when one of its parameters
    was moved or changed in place (``load_state_dict``, an optimizer step;
    not a write through ``.data``), so a frame's launches share one packing."""
    key = (dtype, pe_pts, pe_views,
           tuple((p.data_ptr(), p._version) for p in mlp.parameters()))
    cached = getattr(mlp, "_fused_packed", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            kp = pack_params(mlp, pe_pts, pe_views, dtype)
        blobs = kernel_blobs(kp) if kp["W1"].is_cuda else None
        cached = mlp._fused_packed = (key, kp, blobs)
    return cached[1], cached[2]


def _kernel_config(kp, like: torch.Tensor, tile: bool = True):
    """(dtype, width, point octaves, view octaves) for a launch on
    ``like``'s device; raises on what the kernels are not built for: any
    configuration outside ``supports``, and with ``tile`` (the W <= 256
    tile's launches) one outside ``tile_supports``."""
    dtype = kp["W1"].dtype
    W = kp["W1"].shape[-1]
    Fp, Fv = _num_freqs(kp)
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel computes in bfloat16 or float32, not {dtype}")
    if W % 128 or W < 128 or Fp < 1 or Fv < 1:
        raise ValueError(f"no fused kernel takes width {W} with {Fp} point and {Fv} view "
                         f"octaves (nerf_tpu's guard: a width that is a multiple of 128)")
    if tile and not tile_supports(W, Fp, Fv):
        raise ValueError(
            f"the W <= 256 tile is built for width in {KERNEL_WIDTHS}, <= 10 point and <= 4 "
            f"view octaves; got width {W}, {Fp} and {Fv} (the wide family's configuration)"
        )
    if any(v.device != like.device for v in kp.values()):
        raise ValueError(f"packed params and inputs must be on one device, {like.device}")
    return dtype, W, Fp, Fv


def _wide():
    """ops/fused_mlp_wide.py (imported at first use: it imports this module)."""
    from nerf_tpu_torch.ops import fused_mlp_wide

    return fused_mlp_wide


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.nerf_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")


def _launch(kp, rays_o, rays_d, viewdirs, z_vals, blobs) -> torch.Tensor:
    dtype, W, Fp, Fv = _kernel_config(kp, z_vals)
    lib = _build.load("fused_mlp_fwd")
    R, S = z_vals.shape
    out = torch.empty(4, R, S, dtype=torch.float32, device=z_vals.device)
    if out.numel() == 0:
        return out
    ro, rd, vd, z = (t.contiguous() for t in (rays_o, rays_d, viewdirs, z_vals))
    wblob, bblob = kernel_blobs(kp) if blobs is None else blobs
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.nerf_fused_mlp_fwd(
            int(dtype == torch.bfloat16), W,
            ro.data_ptr(), rd.data_ptr(), vd.data_ptr(), z.data_ptr(),
            R, S, Fp, Fv, wblob.data_ptr(), bblob.data_ptr(), out.data_ptr(), stream,
        )
    _raise_on(lib, err, "fused_mlp_fwd")
    fused_rays_planes.launches += 1
    return out


def fused_rays_planes(
    kp: Dict[str, torch.Tensor],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Raw planes [4, R, S] float32 from packed params, rays [R, 3] and
    depths [R, S]. CUDA tensors launch the kernel (``launches`` counts
    them); CPU tensors take the plain version. ``blobs`` is
    ``kernel_blobs(kp)`` where the caller keeps it across launches."""
    _check_rays(rays_o, rays_d, viewdirs, z_vals)
    if z_vals.device.type == "cpu":
        return fused_rays_planes_reference(kp, rays_o, rays_d, viewdirs, z_vals)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {z_vals.device}")
    if is_wide(kp):
        return _wide().fused_rays_planes_wide(kp, rays_o, rays_d, viewdirs, z_vals, blobs)
    return _launch(kp, rays_o, rays_d, viewdirs, z_vals, blobs)


fused_rays_planes.launches = 0


def _check_points(x: torch.Tensor, v: torch.Tensor, spr: int) -> None:
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"x: expected float32 [N, 3], got {x.dtype} {tuple(x.shape)}")
    N = x.shape[0]
    if spr < 1 or N % spr:
        raise ValueError(f"spr={spr} must be >= 1 and divide the {N} points")
    if v.shape != (N // spr, 3) or v.dtype != torch.float32:
        raise ValueError(f"v: expected float32 {(N // spr, 3)}, got {v.dtype} {tuple(v.shape)}")
    if v.device != x.device:
        raise ValueError(f"v is on {v.device}, x on {x.device}")


def fused_points(
    kp: Dict[str, torch.Tensor],
    x: torch.Tensor,
    v: torch.Tensor,
    spr: int,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Raw [N, 4] float32 from packed params at points x [N, 3], point p
    looking along v[p // spr] (spr = 1: a direction per point; spr = S: per
    ray of S samples). CUDA tensors launch K2 (``launches`` counts them); CPU
    tensors take the plain version. ``blobs`` as for ``fused_rays_planes``."""
    _check_points(x, v, spr)
    if x.device.type == "cpu":
        return fused_points_reference(kp, x, v, spr)
    if x.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {x.device}")
    if is_wide(kp):
        return _wide().fused_points_wide(kp, x, v, spr, blobs)
    dtype, W, Fp, Fv = _kernel_config(kp, x)
    N = x.shape[0]
    out = torch.empty(N, 4, dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    lib = _build.load("fused_mlp_fwd")
    xc, vc = x.contiguous(), v.contiguous()
    wblob, bblob = kernel_blobs(kp) if blobs is None else blobs
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nerf_fused_mlp_fwd_points(
            int(dtype == torch.bfloat16), W, xc.data_ptr(), vc.data_ptr(), N, spr, Fp, Fv,
            wblob.data_ptr(), bblob.data_ptr(), out.data_ptr(), stream,
        )
    _raise_on(lib, err, "fused_mlp_fwd_points")
    fused_points.launches += 1
    return out


fused_points.launches = 0


# ------------------------------------------------------------------ backward


# The cotangent chain's blocks in order: (block, the block its product
# reads, its relu mask), as _mlp_backward_math computes them.
CHAIN = (("dhv", "gc", "hv"), ("dfeat", "dhv", None), ("d7", "dfeat", "h7")) + tuple(
    (f"d{i - 1}", f"d{i}", f"h{i - 1}") for i in range(DEPTH - 1, 0, -1))
BIAS_PART = 64  # points a bias partial of phase 1 sums (csrc/fused_mlp_bwd.cu)


def chain_ws_rows(W: int, ke: int = KE) -> Dict[str, Tuple[int, int]]:
    """(first row, rows) of each of the chain's blocks in the backward's bf16
    workspace (WsRows in csrc/fused_mlp_bwd.cu, at padded embedding width
    ke as in ``ws_rows``): gc's 4 used rows, d0..d7, d_feat, d_hv."""
    gc = ke + DEPTH * W + W + W // 2
    return {"gc": (gc, 4), **{f"d{i}": (gc + 8 + i * W, W) for i in range(DEPTH)},
            "dfeat": (gc + 8 + DEPTH * W, W), "dhv": (gc + 8 + DEPTH * W + W, W // 2)}


class Chain(NamedTuple):
    rows: Dict[str, torch.Tensor]  # chain_ws_rows' blocks: [features, points]
    dhv32: Optional[torch.Tensor]  # d_hv in f32 before its rounding, [points, W/2]
    # each BIAS_PART points' f32 sums of the unrounded cotangents (of g for
    # bout), [parts, width] by bias name (b0..b7, bf, bv, bout)
    bias: Dict[str, torch.Tensor]
    dx: Optional[torch.Tensor]  # [points, 3]
    dv: Optional[torch.Tensor]  # [points / spr, 3]


def _chain_step(kp: Dict[str, torch.Tensor], block: str, prev: torch.Tensor,
                gc: torch.Tensor) -> torch.Tensor:
    """The chain's f32 cotangent ``block`` before its relu mask, from the
    rounded block its product reads, ``prev`` [N, k], and gc [N, 4]."""
    w = lambda name: kp[name].float()  # noqa: E731
    hw = kp["W1"].shape[0] // 2
    if block == "dhv":
        return gc @ w("Wout")[:hw].T
    if block == "dfeat":
        return prev @ w("Wvf").T
    if block == "d7":
        return prev @ w("Wf").T + gc @ w("Wout")[hw:].T
    return prev @ w(f"W{int(block[1:]) + 1}").T


def _chain_blocks(kp: Dict[str, torch.Tensor], g32: torch.Tensor, masks: Dict[str, torch.Tensor],
                  given: Optional[Dict[str, torch.Tensor]] = None):
    """(rounded, unrounded) blocks [N, n] of the cotangent chain by name from
    the cotangent g32 [N, 4] of raw: gc = g32 rounded, then each CHAIN block
    from the rounded block before it (the chain's own, or ``given``'s [N, k]
    where given), times its relu mask (``masks``: bool [N, n] by activation
    name), rounded to kp's dtype."""
    c = lambda t: round_to(t, kp["W1"].dtype)  # noqa: E731
    gc = c(g32)
    rounded, raw = {"gc": gc}, {}
    for name, src, mask in CHAIN:
        prev = rounded[src] if given is None or src not in given else given[src]
        d = _chain_step(kp, name, prev, gc)
        raw[name] = d if mask is None else d * masks[mask]
        rounded[name] = c(raw[name])
    return rounded, raw


def _relu_masks(fw: _Fwd) -> Dict[str, torch.Tensor]:
    """The relu masks the chain applies, by activation name: the rounded
    h0..h6 and the f32 h7 and hv, as nerf_tpu takes them (rounding keeps a
    value's sign)."""
    return {**{f"h{i}": a > 0 for i, a in enumerate(fw.acts)}, "h7": fw.h7 > 0, "hv": fw.hv > 0}


def _input_grads(kp: Dict[str, torch.Tensor], x: torch.Tensor, v: Optional[torch.Tensor],
                 d0: torch.Tensor, d5: torch.Tensor, d_hv_view: torch.Tensor):
    """(dx, dv): dx from d_e = [d0 | d5] W05eᵀ and dv from d_ev = d_hv_view
    Wveᵀ (d_hv rounded after its sum over a view's points) through the f32
    trig of the embeddings (``_embed_backward``); dv None without v."""
    w = lambda name: kp[name].float()  # noqa: E731
    Fp, Fv = _num_freqs(kp)
    dx = _embed_backward(torch.cat([d0, d5], -1) @ w("W05e").T, x, Fp)
    dv = None if v is None else _embed_backward(d_hv_view @ w("Wve").T, v, Fv)
    return dx, dv


def _part_sums(t: torch.Tensor) -> torch.Tensor:
    """[N, n] -> [ceil(N / BIAS_PART), n]: the sums over each BIAS_PART rows."""
    t = F.pad(t, (0, 0, 0, -t.shape[0] % BIAS_PART))
    return t.reshape(-1, BIAS_PART, t.shape[1]).sum(1)


def _chain_result(g32: torch.Tensor, rounded, raw) -> Chain:
    """A Chain of ``_chain_blocks``' output, without input grads."""
    names = ["gc", "dhv", "dfeat"] + [f"d{i}" for i in range(DEPTH)]
    bias = {**{f"b{i}": _part_sums(raw[f"d{i}"]) for i in range(DEPTH)},
            "bf": _part_sums(raw["dfeat"]), "bv": _part_sums(raw["dhv"]),
            "bout": _part_sums(g32)}
    return Chain({k: rounded[k].T.contiguous() for k in names}, raw["dhv"], bias, None, None)


def bwd_chain_reference(kp: Dict[str, torch.Tensor], x: torch.Tensor, v: torch.Tensor, spr: int,
                        g: torch.Tensor, input_grads: bool = False) -> Chain:
    """Plain PyTorch version of the bf16 backward's cotangent chain
    (``bwd_chain_sm90``, after its recompute) from points x [N, 3],
    directions v [N/spr, 3] and the cotangent g [N, 4] of raw: the
    workspace blocks it writes, rounded as the kernel rounds them (gc, d_hv,
    d_feat, d0..d7: ``chain_ws_rows``), d_hv in f32 (which the kernel writes
    for phase 2 with a direction per ray), each BIAS_PART points' bias sums
    and, with ``input_grads``, dx and dv. ``_backward`` takes its cotangents
    from the same code."""
    fw = _forward(kp, x, v, spr, keep_acts=True)
    rounded, raw = _chain_blocks(kp, g, _relu_masks(fw))
    out = _chain_result(g, rounded, raw)
    if not input_grads:
        return out
    hw = kp["W1"].shape[0] // 2
    d_hv_view = round_to(raw["dhv"].reshape(-1, spr, hw).sum(1), kp["W1"].dtype)
    dx, dv = _input_grads(kp, x, v, rounded["d0"], rounded["d5"], d_hv_view)
    return out._replace(dx=dx, dv=dv)


def chain_layers_reference(kp: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
                           masks: torch.Tensor, g: torch.Tensor, spr: int,
                           x: Optional[torch.Tensor] = None,
                           v: Optional[torch.Tensor] = None) -> Chain:
    """Each block of ``bwd_chain_reference`` computed by its one product from
    the block the kernel wrote before it in ``rows`` (a chain launch's rows,
    columns beyond g's N ignored) and from the kernel's own mask words
    ``masks`` ([mask_rows(W), >= N]), not from the reference's own chain: a
    kernel's blocks then differ from these by that product's rounding alone.
    Fed the reference's own rows and masks it gives them back. With x, also
    dx from the rows' d0 and d5, and at spr = 1 dv from their d_hv (v)."""
    W, n = kp["W1"].shape[0], g.shape[0]
    words = {**{f"h{i}": (i * (W // 32), W) for i in range(DEPTH)}, "hv": (DEPTH * (W // 32), W // 2)}
    bits = {k: unpack_mask_bits(masks[m0 : m0 + -(-k_ // 32), :n], k_)
            for k, (m0, k_) in words.items()}
    given = {k: rows[k][:, :n].T.float() for k in ["dhv", "dfeat"] + [f"d{i}" for i in range(1, DEPTH)]}
    rounded, raw = _chain_blocks(kp, g, bits, given)
    out = _chain_result(g, rounded, raw)
    if x is None:
        return out
    d = lambda k: rows[k][:, :n].T.float()  # noqa: E731
    dx, dv = _input_grads(kp, x, v if spr == 1 else None, d("d0"), d("d5"), d("dhv"))
    return out._replace(dx=dx, dv=dv)


def _backward(
    kp: Dict[str, torch.Tensor],
    x: torch.Tensor,
    v: torch.Tensor,
    spr: int,
    g32: torch.Tensor,
    input_grads: bool,
):
    """(f32 grads of every packed leaf, dx [N, 3] | None, dv [N/spr, 3] |
    None) from the cotangent g32 [N, 4] of ``_forward(kp, x, v, spr)``'s raw.

    Mirrors nerf_tpu's _mlp_backward_math step by step, with its rounding
    points (the cotangents from ``_chain_blocks``, as ``bwd_chain_reference``
    takes them): g rounded once (gc); d_hv rounded after its relu mask; dWve
    and d_ev from the per-ray f32 sum of d_hv (the identity at spr = 1),
    rounded after the sum; each trunk cotangent rounded before its products,
    the layer-5 one kept for dW05e = eᵀ [d0 | d5] and d_e = [d0 | d5] W05eᵀ;
    the relu masks from the bf16 trunk activations but the f32 h7 and hv;
    bias grads as f32 sums of the unrounded cotangents; dx and dv through
    the f32 sin/cos of the embeddings (``_embed_backward``). Autograd through
    the plain forward rounds elsewhere and is no reference for the kernels."""
    dtype = kp["W1"].dtype
    c = lambda t: round_to(t, dtype)  # noqa: E731
    hw = kp["W1"].shape[0] // 2
    fw = _forward(kp, x, v, spr, keep_acts=True)
    d, raw = _chain_blocks(kp, g32, _relu_masks(fw))
    h7c, gc = c(fw.h7), d["gc"]
    grads = {
        "Wout": torch.cat([c(fw.hv).T @ gc, h7c.T @ gc], 0),
        "bout": g32.sum(0, keepdim=True),
        "Wvf": c(fw.feat).T @ d["dhv"],
    }
    d_hv_ray_c = c(raw["dhv"].reshape(-1, spr, hw).sum(1))
    grads["Wve"] = fw.ev.T @ d_hv_ray_c
    grads["bv"] = raw["dhv"].sum(0, keepdim=True)
    grads["Wf"] = h7c.T @ d["dfeat"]
    grads["bf"] = raw["dfeat"].sum(0, keepdim=True)
    for i in range(DEPTH - 1, 0, -1):
        grads[f"W{i}"] = fw.acts[i - 1].T @ d[f"d{i}"]
        grads[f"b{i}"] = raw[f"d{i}"].sum(0, keepdim=True)
    grads["W05e"] = fw.e.T @ torch.cat([d["d0"], d["d5"]], -1)
    grads["b0"] = raw["d0"].sum(0, keepdim=True)
    if not input_grads:
        return grads, None, None
    dx, dv = _input_grads(kp, x, v, d["d0"], d["d5"], d_hv_ray_c)
    return grads, dx, dv


def fused_rays_planes_bwd_reference(
    kp: Dict[str, torch.Tensor],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    g_planes: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of K4: float32 grads of every packed leaf (kp's
    shapes) from the cotangent ``g_planes [4, R, S]`` of the raw planes
    (``_backward`` without input grads)."""
    R, S = z_vals.shape
    x = _ray_points(rays_o, rays_d, z_vals)
    grads, _, _ = _backward(kp, x, viewdirs, S, g_planes.reshape(4, R * S).T, False)
    return grads


def fused_points_bwd_reference(
    kp: Dict[str, torch.Tensor],
    x: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    spr: int,
    input_grads: bool = True,
):
    """Plain PyTorch version of K3: (float32 grads of every packed leaf,
    dx [N, 3], dv [N/spr, 3]) from the cotangent ``g [N, 4]`` of
    ``fused_points``'s raw; dx and dv are None without ``input_grads``
    (see ``_backward``)."""
    return _backward(kp, x, v, spr, g, input_grads)


def _chain_blob(kp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The backward's second weight buffer (TLayout in
    csrc/fused_mlp_bwd.cu): W1..W7, Wf and Wvf in kp's own [in, out] layout,
    the B operand of d·Wᵀ; then, for K3's input grads, W05e's layer-0 and
    skip halves and Wve, their embedding rows zero-padded to ``embed_pad``'s
    widths (the tile's 64 / 32). Stacked leaves give each scene's buffer one
    after another."""
    W = kp["W1"].shape[-1]
    lead = kp["W1"].shape[:-2]
    ke, kv = embed_pad(*_num_freqs(kp))
    names = [f"W{i}" for i in range(1, DEPTH)] + ["Wf", "Wvf"]

    def rows(t, k_pad):
        return F.pad(t, (0, 0, 0, k_pad - t.shape[-2])).reshape(*lead, -1)

    w05 = kp["W05e"]
    return torch.cat(
        [kp[n].reshape(*lead, -1) for n in names]
        + [rows(w05[..., :W], ke), rows(w05[..., W:], ke), rows(kp["Wve"], kv)], -1
    ).reshape(-1).contiguous()


def _grad_blocks(W: int, ke: int = KE, kv: int = KV):
    """(name, rows, cols) of K4's f32 output in order (GLayout in
    csrc/fused_mlp_bwd.cu, embedding rows padded to ke / kv: the tile's KE /
    KV, or ``embed_pad``'s for the wide family), then the bias grads as
    (name, width)."""
    weights = (
        [("W05e", ke, 2 * W)]
        + [(f"W{i}", W, W) for i in range(1, DEPTH)]
        + [("Wf", W, W), ("Wvf", W, W // 2), ("Wve", kv, W // 2), ("Wout", 3 * W // 2, 4)]
    )
    biases = [(f"b{i}", W) for i in range(DEPTH)] + [("bf", W), ("bv", W // 2), ("bout", 4)]
    return weights, biases


def _unpack_grads(out: torch.Tensor, W: int, Fp: int, Fv: int) -> Dict[str, torch.Tensor]:
    """K4's f32 output [grad size] (the stacked K4's [S, grad size]) by leaf,
    in kp's shapes (with the leading scene axis)."""
    weights, biases = _grad_blocks(W, *embed_pad(Fp, Fv))
    rows_used = {"W05e": 3 + 6 * Fp, "Wve": 3 + 6 * Fv}
    grads, o = {}, 0
    for name, rows, cols in weights:
        block = out[..., o : o + rows * cols].unflatten(-1, (rows, cols))
        grads[name] = block[..., : rows_used.get(name, rows), :]
        o += rows * cols
    for name, n in biases:
        grads[name] = out[..., o : o + n].unsqueeze(-2)
        o += n
    return grads


def _grad_size(W: int) -> int:
    weights, biases = _grad_blocks(W)
    return sum(r * c for _, r, c in weights) + sum(n for _, n in biases)


# ROADMAP C.8: the most device workspace one backward launch may ask for.
# nerf_tpu's backward keeps its recompute and cotangent chain in VMEM; the
# port's launches write them to device memory, ~10 KB a point at W = 256
# and ~39 KB at 1024 (``bwd_point_bytes``), so the autograd Functions cut a
# larger backward into launches over slices of whole rays (of views of spr
# points; of a ray of every scene), their grads summed in f32. Every path
# chip_smoke.py drives stays one launch: the largest, 8 stacked scenes of
# 1024 rays at W = 512, asks for 33.7 GB.
WORKSPACE_BUDGET = 40 << 30
SLICE_COLS = 256  # a slice's rays (points) are whole wide-family tiles (fused_mlp_wide.TILE)


def bwd_point_bytes(kp: Dict[str, torch.Tensor], spr: int) -> int:
    """Bytes of backward workspace a point takes, at least what K4, K3, K6
    and the wide K4w, K3w, K6w (stacked or not) ask for it: the workspace
    rows, the relu mask words, the bias partials and, with a direction per
    ray (spr > 1), the f32 d_hv rows and its share of the per-ray rows."""
    W = kp["W1"].shape[-1]
    ke, kv = (max(a, b) for a, b in zip(embed_pad(*_num_freqs(kp)), (KE, KV)))
    esz = kp["W1"].element_size()
    nbias = 9 * W + W // 2 + 4
    n = ws_rows(W, ke, kv)[1] * esz + mask_rows(W) * 4 + -(-nbias * 4 // BIAS_PART)
    if spr > 1:
        n += (W // 2) * 4 + -(-(kv + W // 2) * esz // spr)
    return n


def bwd_slices(n: int, item_bytes: int, align: int = 1) -> List[Tuple[int, int]]:
    """Consecutive ranges [a, b) over n items of ``item_bytes`` of backward
    workspace each (a ray's points; a view's; a ray of every scene), each
    range's workspace within WORKSPACE_BUDGET, every cut at a multiple of
    ``align`` items and the ranges as even as that allows: the one range
    (0, n) where all of it fits. A range holds at least ``align`` items."""
    if n * item_bytes <= WORKSPACE_BUDGET:
        return [(0, n)]
    most = max(align, WORKSPACE_BUDGET // item_bytes // align * align)
    count = -(-n // most)
    size = -(-(-(-n // count)) // align) * align  # n / count rounded up to align
    return [(a, min(n, a + size)) for a in range(0, n, size)]


def view_align(spr: int) -> int:
    """Views of spr points a points slice is cut at: whole views whose
    points are whole SLICE_COLS tiles."""
    return SLICE_COLS // math.gcd(SLICE_COLS, spr)


def sum_grads(parts) -> Dict[str, torch.Tensor]:
    """The slices' f32 grads summed leaf by leaf, in slice order (the one
    slice's own where there is one)."""
    total = None
    for part in parts:
        total = part if total is None else {k: total[k] + part[k] for k in total}
    return total


def _points_bwd_sliced(bwd, kp, x, v, g, spr: int, input_grads: bool, dim: int = 0):
    """(grads, dx, dv) of a points backward ``bwd(x, v, g) -> (grads, dx,
    dv)`` over ``bwd_slices`` of x's views of spr points along ``dim`` (1:
    every scene's); dx and dv of each slice written in place."""
    nv = v.shape[dim]
    scenes = x.shape[0] if dim else 1
    slices = bwd_slices(nv, scenes * spr * bwd_point_bytes(kp, spr), view_align(spr))
    if len(slices) == 1:
        return bwd(x, v, g)
    dx = torch.empty_like(x) if input_grads else None
    dv = torch.empty_like(v) if input_grads else None
    parts = []
    for a, b in slices:
        grads, dxs, dvs = bwd(x.narrow(dim, a * spr, (b - a) * spr), v.narrow(dim, a, b - a),
                              g.narrow(dim, a * spr, (b - a) * spr))
        parts.append(grads)
        if input_grads:
            dx.narrow(dim, a * spr, (b - a) * spr).copy_(dxs)
            dv.narrow(dim, a, b - a).copy_(dvs)
    return sum_grads(parts), dx, dv


def _workspace(lib, query, name: str, *args, dev) -> Tuple[torch.Tensor, int]:
    """The device workspace a backward launch asks ``query`` for."""
    nbytes = ctypes.c_longlong(0)
    _raise_on(lib, query(*args, ctypes.byref(nbytes)), name)
    return torch.empty(nbytes.value, dtype=torch.uint8, device=dev), nbytes.value


def _launch_bwd(kp, rays_o, rays_d, viewdirs, z_vals, g, blobs) -> Dict[str, torch.Tensor]:
    """K4's three phases on the cotangent planes ``g``. The caller counts
    the launch: K4's wrapper, or K6's (experimental/fused_render.py), whose
    backward ends with these phases."""
    dtype, W, Fp, Fv = _kernel_config(kp, z_vals)
    dev = z_vals.device
    R, S = z_vals.shape
    out = torch.zeros(_grad_size(W), dtype=torch.float32, device=dev)
    if R * S == 0:
        return _unpack_grads(out, W, Fp, Fv)
    lib = _build.load("fused_mlp_bwd")
    use_bf16 = int(dtype == torch.bfloat16)
    ws, nbytes = _workspace(lib, lib.nerf_fused_mlp_bwd_workspace, "fused_mlp_bwd",
                            use_bf16, W, R, S, dev=dev)
    ro, rd, vd, z, gp = (t.contiguous() for t in (rays_o, rays_d, viewdirs, z_vals, g))
    wblob, bblob = kernel_blobs(kp) if blobs is None else blobs
    wtblob = _chain_blob(kp)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_fused_mlp_bwd(
            use_bf16, W, ro.data_ptr(), rd.data_ptr(), vd.data_ptr(), z.data_ptr(),
            gp.data_ptr(), R, S, Fp, Fv, wblob.data_ptr(), wtblob.data_ptr(),
            bblob.data_ptr(), ws.data_ptr(), nbytes, out.data_ptr(), stream,
        )
    _raise_on(lib, err, "fused_mlp_bwd")
    bwd_recompute.launches += use_bf16
    bwd_chain.launches += use_bf16
    return _unpack_grads(out, W, Fp, Fv)


def _nan_workspace(W: int, n: int, dev):
    """(the bf16 workspace rows, NaN everywhere so that a row a launch leaves
    unwritten shows, and the mask words) of n points in whole tiles."""
    n_pad = -(-n // FWD_TILE) * FWD_TILE
    ws = torch.full((ws_rows(W)[1], n_pad), float("nan"), dtype=torch.bfloat16, device=dev)
    return ws, torch.empty(mask_rows(W), n_pad, dtype=torch.int32, device=dev)


def _recompute_rows(ws: torch.Tensor, W: int, spr: int) -> Dict[str, torch.Tensor]:
    """The recompute's blocks of the workspace ws (the view embedding's only
    with a direction per point)."""
    return {k: ws[r0 : r0 + n_k] for k, (r0, n_k) in ws_rows(W)[0].items() if k != "ev" or spr == 1}


def _launch_recompute(kp, entry: str, args, n: int, spr: int, raw: bool, like: torch.Tensor,
                      blobs) -> Recompute:
    dtype, W, Fp, Fv = _kernel_config(kp, like)
    if dtype != torch.bfloat16:
        raise ValueError("the recompute is a launch of the bf16 backward only")
    dev = like.device
    ws, masks = _nan_workspace(W, n, dev)
    out = torch.empty(n * 4, dtype=torch.float32, device=dev) if raw else None
    if n:
        lib = _build.load("fused_mlp_bwd")
        wblob, bblob = kernel_blobs(kp) if blobs is None else blobs
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, entry)(W, *args, Fp, Fv, wblob.data_ptr(), bblob.data_ptr(),
                                      ws.data_ptr(), masks.data_ptr(),
                                      0 if out is None else out.data_ptr(), stream)
        _raise_on(lib, err, entry)
        bwd_recompute.launches += 1
    if out is not None:
        out = out.view(4, n).T if entry == "nerf_fused_mlp_bwd_recompute" else out.view(n, 4)
    return Recompute(_recompute_rows(ws, W, spr), masks, out)


def bwd_recompute(kp: Dict[str, torch.Tensor], x: torch.Tensor, v: torch.Tensor, spr: int,
                  raw: bool = False, blobs=None) -> Recompute:
    """The bf16 backward's recompute launch alone (K3's first launch), on
    points x [N, 3] and directions v [N/spr, 3], for a check of what it
    writes: on a CUDA tensor the kernel's workspace rows and mask words over
    all of its whole tiles (N rounded up to 128 columns; the view
    embedding's rows only at spr = 1) and, with ``raw``, its raw [N, 4]; on
    a CPU tensor ``bwd_recompute_reference``. ``launches`` counts the
    recompute's launches, K4's, K3's and K6's included."""
    _check_points(x, v, spr)
    if x.device.type == "cpu":
        ref = bwd_recompute_reference(kp, x, v, spr)
        return ref if raw else ref._replace(raw=None)
    if x.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {x.device}")
    xc, vc = x.contiguous(), v.contiguous()
    return _launch_recompute(kp, "nerf_fused_mlp_bwd_recompute_points",
                             (xc.data_ptr(), vc.data_ptr(), x.shape[0], spr), x.shape[0], spr,
                             raw, x, blobs)


bwd_recompute.launches = 0


def bwd_recompute_rays(kp: Dict[str, torch.Tensor], rays_o: torch.Tensor, rays_d: torch.Tensor,
                       viewdirs: torch.Tensor, z_vals: torch.Tensor, raw: bool = False,
                       blobs=None) -> Recompute:
    """``bwd_recompute`` in ray mode (K4's first launch): rays [R, 3] and
    depths [R, S], the points x = o + d·z; raw [R*S, 4] with ``raw``."""
    _check_rays(rays_o, rays_d, viewdirs, z_vals)
    R, S = z_vals.shape
    if z_vals.device.type == "cpu":
        ref = bwd_recompute_reference(kp, _ray_points(rays_o, rays_d, z_vals), viewdirs, S)
        return ref if raw else ref._replace(raw=None)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {z_vals.device}")
    ro, rd, vd, z = (t.contiguous() for t in (rays_o, rays_d, viewdirs, z_vals))
    return _launch_recompute(kp, "nerf_fused_mlp_bwd_recompute",
                             (ro.data_ptr(), rd.data_ptr(), vd.data_ptr(), z.data_ptr(), R, S),
                             R * S, S, raw, z_vals, blobs)


def bwd_recompute_stacked(kp: Dict[str, torch.Tensor], x: torch.Tensor, v: torch.Tensor,
                          spr: int, blobs=None) -> Recompute:
    """The stacked K3's recompute launch alone (``SceneWalk``: a net per
    scene), on S scenes' points x [S, P, 3] and directions v [S, P/spr, 3]
    through stacked packed params ([S, ...] leaves), for a check of what it
    writes: each scene's points zero-padded to ``_pad_points`` (P_pad), the
    workspace rows and mask words over all S * P_pad columns, scene s's at
    [s * P_pad, (s + 1) * P_pad); no raw. On a CPU tensor
    ``bwd_recompute_reference`` scene by scene on the padded points, side by
    side (the view embedding's rows, as the kernel's, only at spr = 1).
    ``bwd_recompute.launches`` counts it."""
    _check_stacked_points(kp, x, v, spr)
    S, P, _ = x.shape
    P_pad = _pad_points(P, spr)
    (xp,), (vp,) = _padded((x,), P_pad), _padded((v,), P_pad // spr)
    if x.device.type == "cpu":
        per = [bwd_recompute_reference(_scene(kp, s), xp[s], vp[s], spr) for s in range(S)]
        return Recompute({k: torch.cat([r.rows[k] for r in per], 1) for k in per[0].rows
                          if k != "ev" or spr == 1}, torch.cat([r.masks for r in per], 1), None)
    if x.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {x.device}")
    return _launch_recompute(kp, "nerf_fused_mlp_bwd_recompute_points_stacked",
                             (xp.data_ptr(), vp.data_ptr(), S, P_pad, spr), S * P_pad, spr, False,
                             x, blobs)


def _launch_chain(kp, entry: str, args, n: int, spr: int, like: torch.Tensor, input_grads: bool,
                  blobs) -> Tuple[Recompute, Chain]:
    dtype, W, Fp, Fv = _kernel_config(kp, like)
    if dtype != torch.bfloat16:
        raise ValueError("the chain is a launch of the bf16 backward only")
    dev = like.device
    ws, masks = _nan_workspace(W, n, dev)
    n_pad = ws.shape[1]
    _, biases = _grad_blocks(W)
    nan = float("nan")  # as in the workspace: what the launches leave unwritten shows
    dhv32 = torch.full((n_pad, W // 2), nan, device=dev) if spr > 1 else None
    bpart = torch.full((n_pad // BIAS_PART, sum(k for _, k in biases)), nan, device=dev)
    dx = torch.full((n, 3), nan, device=dev) if input_grads else None
    dv = torch.full((n, 3), nan, device=dev) if input_grads and spr == 1 else None
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    if n:
        lib = _build.load("fused_mlp_bwd")
        wblob, bblob = kernel_blobs(kp) if blobs is None else blobs
        wtblob = _chain_blob(kp)
        tail = (ptr(dx), ptr(dv)) if entry.endswith("_points") else ()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, entry)(W, *args, Fp, Fv, wblob.data_ptr(), wtblob.data_ptr(),
                                      bblob.data_ptr(), ws.data_ptr(), masks.data_ptr(),
                                      ptr(dhv32), bpart.data_ptr(), *tail, stream)
        _raise_on(lib, err, entry)
        bwd_recompute.launches += 1
        bwd_chain.launches += 1
    rec = Recompute(_recompute_rows(ws, W, spr), masks, None)
    bias, o = {}, 0
    for name, k in biases:
        bias[name] = bpart[:, o : o + k]
        o += k
    rows = {k: ws[r0 : r0 + n_k] for k, (r0, n_k) in chain_ws_rows(W).items()}
    return rec, Chain(rows, dhv32, bias, dx, dv)


def bwd_chain(kp: Dict[str, torch.Tensor], x: torch.Tensor, v: torch.Tensor, spr: int,
              g: torch.Tensor, input_grads: bool = False, blobs=None) -> Tuple[Recompute, Chain]:
    """The bf16 backward's recompute and cotangent chain alone (K3's first
    two launches) on points x [N, 3], directions v [N/spr, 3] and the
    cotangent g [N, 4] of raw, for a check of what the chain writes: on a
    CUDA tensor the recompute's rows and mask words (as ``bwd_recompute``'s,
    without raw) and the chain's (``Chain``: its rows over all of its whole
    tiles, the f32 d_hv rows at spr > 1 only, a bias partial per BIAS_PART
    points of the whole tiles, and with ``input_grads`` dx and, at spr = 1,
    dv, which phase 2 computes otherwise); on a CPU tensor
    ``bwd_recompute_reference`` and ``bwd_chain_reference``. ``launches``
    counts the chain's launches, K4's, K3's and K6's included."""
    _check_points(x, v, spr)
    N = x.shape[0]
    if g.shape != (N, 4) or g.dtype != torch.float32 or g.device != x.device:
        raise ValueError(f"g: expected float32 {(N, 4)} on {x.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    if x.device.type == "cpu":
        return (bwd_recompute_reference(kp, x, v, spr)._replace(raw=None),
                bwd_chain_reference(kp, x, v, spr, g, input_grads))
    if x.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {x.device}")
    xc, vc, gc = x.contiguous(), v.contiguous(), g.contiguous()
    return _launch_chain(kp, "nerf_fused_mlp_bwd_chain_points",
                         (xc.data_ptr(), vc.data_ptr(), gc.data_ptr(), N, spr), N, spr, x,
                         input_grads, blobs)


bwd_chain.launches = 0


def bwd_chain_rays(kp: Dict[str, torch.Tensor], rays_o: torch.Tensor, rays_d: torch.Tensor,
                   viewdirs: torch.Tensor, z_vals: torch.Tensor, g_planes: torch.Tensor,
                   blobs=None) -> Tuple[Recompute, Chain]:
    """``bwd_chain`` in ray mode (K4's first two launches): rays [R, 3],
    depths [R, S] and the cotangent planes g_planes [4, R, S]; no input
    grads."""
    _check_rays(rays_o, rays_d, viewdirs, z_vals)
    R, S = z_vals.shape
    if g_planes.shape != (4, R, S) or g_planes.dtype != torch.float32 or \
            g_planes.device != z_vals.device:
        raise ValueError(f"g_planes: expected float32 {(4, R, S)} on {z_vals.device}")
    if z_vals.device.type == "cpu":
        x = _ray_points(rays_o, rays_d, z_vals)
        return (bwd_recompute_reference(kp, x, viewdirs, S)._replace(raw=None),
                bwd_chain_reference(kp, x, viewdirs, S, g_planes.reshape(4, R * S).T))
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {z_vals.device}")
    ro, rd, vd, z, gp = (t.contiguous() for t in (rays_o, rays_d, viewdirs, z_vals, g_planes))
    return _launch_chain(kp, "nerf_fused_mlp_bwd_chain",
                         (ro.data_ptr(), rd.data_ptr(), vd.data_ptr(), z.data_ptr(), gp.data_ptr(),
                          R, S), R * S, S, z_vals, False, blobs)


def fused_rays_planes_bwd(
    kp: Dict[str, torch.Tensor],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    g_planes: torch.Tensor,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """float32 grads of the packed leaves (kp's shapes) from the cotangent
    ``g_planes [4, R, S]`` of ``fused_rays_planes``'s output. CUDA tensors
    launch K4 (``launches`` counts them); CPU tensors take the plain
    version."""
    _check_rays(rays_o, rays_d, viewdirs, z_vals)
    R, S = z_vals.shape
    if g_planes.shape != (4, R, S) or g_planes.dtype != torch.float32:
        raise ValueError(
            f"g_planes: expected float32 {(4, R, S)}, got {g_planes.dtype} {tuple(g_planes.shape)}"
        )
    if g_planes.device != z_vals.device:
        raise ValueError(f"g_planes is on {g_planes.device}, z_vals on {z_vals.device}")
    if z_vals.device.type == "cpu":
        return fused_rays_planes_bwd_reference(kp, rays_o, rays_d, viewdirs, z_vals, g_planes)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {z_vals.device}")
    if is_wide(kp):
        return _wide().fused_rays_planes_wide_bwd(kp, rays_o, rays_d, viewdirs, z_vals, g_planes,
                                                  blobs)
    grads = _launch_bwd(kp, rays_o, rays_d, viewdirs, z_vals, g_planes, blobs)
    if R * S:
        fused_rays_planes_bwd.launches += 1
    return grads


fused_rays_planes_bwd.launches = 0


def fused_points_bwd(
    kp: Dict[str, torch.Tensor],
    x: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    spr: int,
    input_grads: bool = True,
    blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """(float32 grads of the packed leaves, dx [N, 3], dv [N/spr, 3]) from
    the cotangent ``g [N, 4]`` of ``fused_points``'s output; dx and dv are
    None without ``input_grads``, and K3 then skips their branch. CUDA
    tensors launch K3 (``launches`` counts them); CPU tensors take the plain
    version."""
    _check_points(x, v, spr)
    N = x.shape[0]
    if g.shape != (N, 4) or g.dtype != torch.float32:
        raise ValueError(f"g: expected float32 {(N, 4)}, got {g.dtype} {tuple(g.shape)}")
    if g.device != x.device:
        raise ValueError(f"g is on {g.device}, x on {x.device}")
    if x.device.type == "cpu":
        return fused_points_bwd_reference(kp, x, v, g, spr, input_grads)
    if x.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {x.device}")
    if is_wide(kp):
        return _wide().fused_points_wide_bwd(kp, x, v, g, spr, input_grads, blobs)
    dtype, W, Fp, Fv = _kernel_config(kp, x)
    dev = x.device
    out = torch.zeros(_grad_size(W), dtype=torch.float32, device=dev)
    dx = torch.empty(N, 3, dtype=torch.float32, device=dev) if input_grads else None
    dv = torch.empty(N // spr, 3, dtype=torch.float32, device=dev) if input_grads else None
    if N == 0:
        return _unpack_grads(out, W, Fp, Fv), dx, dv
    lib = _build.load("fused_mlp_bwd")
    use_bf16 = int(dtype == torch.bfloat16)
    ws, nbytes = _workspace(lib, lib.nerf_fused_mlp_bwd_points_workspace,
                            "fused_mlp_bwd_points", use_bf16, W, N, spr, dev=dev)
    xc, vc, gc = (t.contiguous() for t in (x, v, g))
    wblob, bblob = kernel_blobs(kp) if blobs is None else blobs
    wtblob = _chain_blob(kp)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_fused_mlp_bwd_points(
            use_bf16, W, xc.data_ptr(), vc.data_ptr(), gc.data_ptr(), N, spr, Fp, Fv,
            wblob.data_ptr(), wtblob.data_ptr(), bblob.data_ptr(), ws.data_ptr(), nbytes,
            out.data_ptr(), 0 if dx is None else dx.data_ptr(),
            0 if dv is None else dv.data_ptr(), stream,
        )
    _raise_on(lib, err, "fused_mlp_bwd_points")
    fused_points_bwd.launches += 1
    bwd_recompute.launches += use_bf16
    bwd_chain.launches += use_bf16
    return _unpack_grads(out, W, Fp, Fv), dx, dv


fused_points_bwd.launches = 0


class _FusedRaysPlanes(torch.autograd.Function):
    """K1 forward, K4 backward over the packed leaves (in KP_NAMES order).
    Rays, viewdirs and depths get no gradient, as in nerf_tpu's
    _fused_rays_bwd_rule; each leaf's grad comes back in its own dtype
    (bf16 weights, f32 biases), as ``dkp = g_.astype(kp[n_].dtype)`` there."""

    @staticmethod
    def forward(ctx, rays_o, rays_d, viewdirs, z_vals, *leaves):
        kp = dict(zip(KP_NAMES, leaves))
        blobs = kernel_blobs(kp) if z_vals.is_cuda else None
        ctx.save_for_backward(rays_o, rays_d, viewdirs, z_vals, *leaves)
        ctx.blobs = blobs
        return fused_rays_planes(kp, rays_o, rays_d, viewdirs, z_vals, blobs)

    @staticmethod
    def backward(ctx, g):
        ro, rd, vd, z, *leaves = ctx.saved_tensors
        kp = dict(zip(KP_NAMES, leaves))
        g = g.contiguous()
        R, S = z.shape
        grads = sum_grads(
            fused_rays_planes_bwd(kp, ro[a:b], rd[a:b], vd[a:b], z[a:b], g[:, a:b], ctx.blobs)
            for a, b in bwd_slices(R, S * bwd_point_bytes(kp, S), SLICE_COLS))
        ctx.blobs = None
        return (None,) * 4 + tuple(grads[n].to(kp[n].dtype) for n in KP_NAMES)


def fused_rays_planes_autograd(kp, rays_o, rays_d, viewdirs, z_vals) -> torch.Tensor:
    """``fused_rays_planes`` that differentiates into the packed leaves."""
    _check_rays(rays_o, rays_d, viewdirs, z_vals)
    return _FusedRaysPlanes.apply(
        rays_o.detach(), rays_d.detach(), viewdirs.detach(), z_vals.detach(),
        *(kp[n] for n in KP_NAMES),
    )


def fused_query_rays_planes(
    mlp: NeRFMLP,
    cfg: MLPConfig,
    pe_pts: PosEncConfig,
    pe_views: PosEncConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Rays + depths in, raw planes [4, R, S] out (nerf_tpu's
    fused_query_rays_planes). Under autograd (grad enabled and a parameter
    that requires grad) the weights are packed anew with their graph and the
    call differentiates through K4; otherwise the packing kept on the module
    serves the forward alone."""
    if not supports(cfg, pe_pts, pe_views):
        raise ValueError("fused_query_rays_planes: unsupported MLP / posenc configuration")
    if torch.is_grad_enabled() and any(p.requires_grad for p in mlp.parameters()):
        kp = pack_params(mlp, pe_pts, pe_views, compute_dtype)
        return fused_rays_planes_autograd(kp, rays_o, rays_d, viewdirs, z_vals)
    kp, blobs = packed_params(mlp, pe_pts, pe_views, compute_dtype)
    return fused_rays_planes(kp, rays_o, rays_d, viewdirs, z_vals, blobs)


class _FusedPoints(torch.autograd.Function):
    """K2 forward, K3 backward over the packed leaves (in KP_NAMES order),
    with grads to x and v only when ``input_grads`` (nerf_tpu's
    _fused_bwd_rule returns zeros there; here they are None)."""

    @staticmethod
    def forward(ctx, x, v, spr, input_grads, *leaves):
        kp = dict(zip(KP_NAMES, leaves))
        blobs = kernel_blobs(kp) if x.is_cuda else None
        ctx.save_for_backward(x, v, *leaves)
        ctx.blobs, ctx.spr, ctx.input_grads = blobs, spr, input_grads
        return fused_points(kp, x, v, spr, blobs)

    @staticmethod
    def backward(ctx, g):
        x, v, *leaves = ctx.saved_tensors
        kp = dict(zip(KP_NAMES, leaves))
        spr, input_grads = ctx.spr, ctx.input_grads
        grads, dx, dv = _points_bwd_sliced(
            lambda xs, vs, gs: fused_points_bwd(kp, xs, vs, gs, spr, input_grads, ctx.blobs),
            kp, x, v, g.contiguous(), spr, input_grads)
        ctx.blobs = None
        return (dx, dv, None, None) + tuple(grads[n].to(kp[n].dtype) for n in KP_NAMES)


def fused_query(
    mlp: NeRFMLP,
    cfg: MLPConfig,
    pe_pts: PosEncConfig,
    pe_views: PosEncConfig,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
    input_grads: bool = True,
) -> torch.Tensor:
    """Points [R, S, 3] and view directions [R, 3] in, raw [R, S, 4] out
    (nerf_tpu's fused_query). With S a multiple of 8 the directions stay per
    ray (spr = S); otherwise they are broadcast per point (spr = 1), so
    autograd's expand sums dv over a ray's samples as JAX's broadcast does.
    ``input_grads=False``: K3 skips the dx/dv branch and pts/viewdirs get no
    grad (for callers that detach them, as the renderer does). Under
    autograd the weights are packed anew with their graph; otherwise the
    packing kept on the module serves the forward alone."""
    if not supports(cfg, pe_pts, pe_views):
        raise ValueError("fused_query: unsupported MLP / posenc configuration")
    R, S, _ = pts.shape
    x = pts.reshape(R * S, 3)
    if S % 8 == 0 and S > 1:
        v, spr = viewdirs, S
    else:
        v, spr = viewdirs[:, None, :].expand(R, S, 3).reshape(R * S, 3), 1
    wants_grad = any(p.requires_grad for p in mlp.parameters()) or (
        input_grads and (pts.requires_grad or viewdirs.requires_grad))
    if torch.is_grad_enabled() and wants_grad:
        kp = pack_params(mlp, pe_pts, pe_views, compute_dtype)
        if not input_grads:
            x, v = x.detach(), v.detach()
        out = _FusedPoints.apply(x, v, spr, input_grads, *(kp[n] for n in KP_NAMES))
    else:
        kp, blobs = packed_params(mlp, pe_pts, pe_views, compute_dtype)
        out = fused_points(kp, x, v, spr, blobs)
    return out.reshape(R, S, 4)


# ------------------------------------------------- stacked (multi-scene) K1/K4
#
# Multi-scene training (parallel/multi_scene.py) runs S nets of one shape as
# one stacked step: the packed leaves carry a leading scene axis [S, ...],
# the rays of scene s are [s] of [S, R, ...] inputs, and each level runs one
# K1 launch and one K4 launch (its three phases) over every scene's rays,
# each tile reading its own scene's weights (nerf_tpu vmaps its step, and
# with it the Pallas calls, over the scene axis: multi_scene.py:44-64).


def _scene(kp: Dict[str, torch.Tensor], s: int) -> Dict[str, torch.Tensor]:
    """Scene s's leaves of stacked packed params."""
    return {k: v[s] for k, v in kp.items()}


def _check_stacked(kp, rays_o, rays_d, viewdirs, z_vals) -> None:
    S = z_vals.shape[0]
    if z_vals.dim() != 3 or kp["W1"].dim() != 3 or kp["W1"].shape[0] != S:
        raise ValueError(f"stacked inputs: z_vals [S, R, N] and leaves [S, ...]; got z_vals "
                         f"{tuple(z_vals.shape)} and W1 {tuple(kp['W1'].shape)}")
    _check_rays(*(t.flatten(0, 1) for t in (rays_o, rays_d, viewdirs, z_vals)))
    if rays_o.shape[0] != S:
        raise ValueError(f"rays_o: expected {S} scenes, got {tuple(rays_o.shape)}")


def fused_rays_planes_stacked_reference(kp, rays_o, rays_d, viewdirs, z_vals) -> torch.Tensor:
    """Plain PyTorch version of the stacked K1: K1's plain version applied
    scene by scene, raw planes [4, S, R, N]."""
    return torch.stack([fused_rays_planes_reference(_scene(kp, s), rays_o[s], rays_d[s],
                                                    viewdirs[s], z_vals[s])
                        for s in range(z_vals.shape[0])], 1)


def fused_rays_planes_stacked_bwd_reference(kp, rays_o, rays_d, viewdirs, z_vals,
                                            g_planes) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the stacked K4: K4's plain version applied
    scene by scene, grads with kp's stacked shapes."""
    per = [fused_rays_planes_bwd_reference(_scene(kp, s), rays_o[s], rays_d[s], viewdirs[s],
                                           z_vals[s], g_planes[:, s])
           for s in range(z_vals.shape[0])]
    return {k: torch.stack([g[k] for g in per]) for k in per[0]}


def _pad_rays(R: int, N: int) -> int:
    """The rays a scene is padded to for the stacked launches: a multiple of
    64 (whole 64-ray columns of K4's per-ray rows) whose R*N points are
    whole tiles, so that no tile spans two scenes (at an odd N, a multiple
    of 128). The points mode takes views of spr points for rays of N
    samples (``_pad_points``); K5's ray groups, 128 / gcd(N, 128) rays, then
    fill the scene too."""
    step = 64 if (64 * N) % FWD_TILE == 0 else 128
    return -(-R // step) * step


def _pad_points(P: int, spr: int) -> int:
    """The points a scene is padded to for the stacked points launches
    (K2s, K3s): ``_pad_rays`` over its P / spr views of spr points, so
    whole views, whole tiles and, at spr > 1, whole 64-view columns."""
    return _pad_rays(P // spr, spr) * spr


def _padded(ts, R_pad: int, dim: int = 1):
    """Each tensor zero-padded along ``dim`` to R_pad, contiguous."""
    return [F.pad(t, (0, 0) * (t.dim() - dim - 1) + (0, R_pad - t.shape[dim])).contiguous()
            for t in ts]


def fused_rays_planes_stacked(kp, rays_o, rays_d, viewdirs, z_vals, blobs=None) -> torch.Tensor:
    """Raw planes [4, S, R, N] float32 of S scenes from stacked packed
    params ([S, ...] leaves), rays [S, R, 3] and depths [S, R, N]: scene s's
    rays through scene s's net. CUDA tensors launch the stacked K1 once for
    every scene (``launches`` counts one a launch, whatever S is), each
    scene's rays zero-padded to ``_pad_rays``, or where ``is_wide`` K1ws
    (ops/fused_mlp_wide.py); CPU tensors take the plain version. ``blobs``
    is ``kernel_blobs(kp)`` where the caller keeps it."""
    _check_stacked(kp, rays_o, rays_d, viewdirs, z_vals)
    if z_vals.device.type == "cpu":
        return fused_rays_planes_stacked_reference(kp, rays_o, rays_d, viewdirs, z_vals)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {z_vals.device}")
    if is_wide(kp):
        return _wide().fused_rays_planes_wide_stacked(kp, rays_o, rays_d, viewdirs, z_vals, blobs)
    dtype, W, Fp, Fv = _kernel_config(kp, z_vals)
    S, R, N = z_vals.shape
    R_pad = _pad_rays(R, N)
    ro, rd, vd, z = _padded((rays_o, rays_d, viewdirs, z_vals), R_pad)
    out = torch.empty(4, S, R_pad, N, dtype=torch.float32, device=z.device)
    lib = _build.load("fused_mlp_fwd")
    wblob, bblob = kernel_blobs(kp) if blobs is None else blobs
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.nerf_fused_mlp_fwd_stacked(
            int(dtype == torch.bfloat16), W, ro.data_ptr(), rd.data_ptr(), vd.data_ptr(),
            z.data_ptr(), S, R_pad, N, Fp, Fv, wblob.data_ptr(), bblob.data_ptr(),
            out.data_ptr(), stream,
        )
    _raise_on(lib, err, "fused_mlp_fwd_stacked")
    fused_rays_planes_stacked.launches += 1
    return out[:, :, :R]


fused_rays_planes_stacked.launches = 0


def stacked_workspace_bytes(W: int, n_scenes: int, rays_per_scene: int, n_samples: int,
                            bf16: bool = True) -> int:
    """Bytes of device workspace that one stacked K4 launch takes (after
    ``_pad_rays``); asks the built library."""
    lib = _build.load("fused_mlp_bwd")
    nbytes = ctypes.c_longlong(0)
    R_pad = _pad_rays(rays_per_scene, n_samples)
    _raise_on(lib, lib.nerf_fused_mlp_bwd_stacked_workspace(
        int(bf16), W, n_scenes, R_pad, n_samples, ctypes.byref(nbytes)), "fused_mlp_bwd_stacked")
    return nbytes.value


def fused_rays_planes_stacked_bwd(kp, rays_o, rays_d, viewdirs, z_vals, g_planes,
                                  blobs=None) -> Dict[str, torch.Tensor]:
    """float32 grads of the stacked packed leaves (kp's [S, ...] shapes)
    from the cotangent ``g_planes [4, S, R, N]`` of
    ``fused_rays_planes_stacked``'s output: each scene's the grads of its own
    net. CUDA tensors launch the stacked K4 (its recompute, chain and weight
    grads once each for every scene; ``launches`` counts one); CPU tensors
    take the plain version."""
    _check_stacked(kp, rays_o, rays_d, viewdirs, z_vals)
    S, R, N = z_vals.shape
    if g_planes.shape != (4, S, R, N) or g_planes.dtype != torch.float32 or \
            g_planes.device != z_vals.device:
        raise ValueError(f"g_planes: expected float32 {(4, S, R, N)} on {z_vals.device}, got "
                         f"{g_planes.dtype} {tuple(g_planes.shape)} on {g_planes.device}")
    if z_vals.device.type == "cpu":
        return fused_rays_planes_stacked_bwd_reference(kp, rays_o, rays_d, viewdirs, z_vals,
                                                       g_planes)
    if z_vals.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {z_vals.device}")
    if is_wide(kp):
        return _wide().fused_rays_planes_wide_stacked_bwd(kp, rays_o, rays_d, viewdirs, z_vals,
                                                          g_planes, blobs)
    R_pad = _pad_rays(R, N)
    (g,) = _padded((g_planes,), R_pad, dim=2)  # padded rays: a zero cotangent
    grads = _launch_stacked_bwd(kp, *_padded((rays_o, rays_d, viewdirs, z_vals), R_pad), g, blobs)
    fused_rays_planes_stacked_bwd.launches += 1
    return grads


def _launch_stacked_bwd(kp, ro, rd, vd, z, g, blobs) -> Dict[str, torch.Tensor]:
    """The stacked K4's launches on padded inputs (rays [S, R_pad, 3], depths
    [S, R_pad, N], cotangent planes [4, S, R_pad, N], contiguous). The caller
    counts the launch: the stacked K4's wrapper, or the stacked K6's
    (experimental/fused_render.py), whose backward ends with these phases."""
    dtype, W, Fp, Fv = _kernel_config(kp, z)
    dev = z.device
    S, R_pad, N = z.shape
    lib = _build.load("fused_mlp_bwd")
    use_bf16 = int(dtype == torch.bfloat16)
    ws, nbytes = _workspace(lib, lib.nerf_fused_mlp_bwd_stacked_workspace, "fused_mlp_bwd_stacked",
                            use_bf16, W, S, R_pad, N, dev=dev)
    out = torch.zeros(S, _grad_size(W), dtype=torch.float32, device=dev)
    wblob, bblob = kernel_blobs(kp) if blobs is None else blobs
    wtblob = _chain_blob(kp)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_fused_mlp_bwd_stacked(
            use_bf16, W, ro.data_ptr(), rd.data_ptr(), vd.data_ptr(), z.data_ptr(), g.data_ptr(),
            S, R_pad, N, Fp, Fv, wblob.data_ptr(), wtblob.data_ptr(), bblob.data_ptr(),
            ws.data_ptr(), nbytes, out.data_ptr(), stream,
        )
    _raise_on(lib, err, "fused_mlp_bwd_stacked")
    bwd_recompute.launches += use_bf16
    bwd_chain.launches += use_bf16
    return _unpack_grads(out, W, Fp, Fv)


fused_rays_planes_stacked_bwd.launches = 0


class _FusedRaysPlanesStacked(torch.autograd.Function):
    """The stacked K1 forward, the stacked K4 backward over stacked packed
    leaves (KP_NAMES order), as ``_FusedRaysPlanes`` for one net."""

    @staticmethod
    def forward(ctx, rays_o, rays_d, viewdirs, z_vals, *leaves):
        kp = dict(zip(KP_NAMES, leaves))
        blobs = kernel_blobs(kp) if z_vals.is_cuda else None
        ctx.save_for_backward(rays_o, rays_d, viewdirs, z_vals, *leaves)
        ctx.blobs = blobs
        return fused_rays_planes_stacked(kp, rays_o, rays_d, viewdirs, z_vals, blobs)

    @staticmethod
    def backward(ctx, g):
        ro, rd, vd, z, *leaves = ctx.saved_tensors
        kp = dict(zip(KP_NAMES, leaves))
        g = g.contiguous()
        S, R, N = z.shape
        grads = sum_grads(
            fused_rays_planes_stacked_bwd(kp, ro[:, a:b], rd[:, a:b], vd[:, a:b], z[:, a:b],
                                          g[:, :, a:b], ctx.blobs)
            for a, b in bwd_slices(R, S * N * bwd_point_bytes(kp, N), SLICE_COLS))
        ctx.blobs = None
        return (None,) * 4 + tuple(grads[n].to(kp[n].dtype) for n in KP_NAMES)


def fused_query_rays_planes_stacked(mlp, cfg: MLPConfig, pe_pts: PosEncConfig,
                                    pe_views: PosEncConfig, rays_o: torch.Tensor,
                                    rays_d: torch.Tensor, viewdirs: torch.Tensor,
                                    z_vals: torch.Tensor,
                                    compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``fused_query_rays_planes`` for a stacked net (render/network.py's
    StackedNeRFMLP): rays [S, R, 3] and depths [S, R, N] in, raw planes
    [4, S, R, N] out, scene s's through scene s's net; rays and depths get
    no gradient."""
    if not supports_stacked(cfg, pe_pts, pe_views):
        raise ValueError("fused_query_rays_planes_stacked: unsupported MLP / posenc configuration")
    if torch.is_grad_enabled() and any(p.requires_grad for p in mlp.parameters()):
        kp = pack_params(mlp, pe_pts, pe_views, compute_dtype)
        _check_stacked(kp, rays_o, rays_d, viewdirs, z_vals)
        return _FusedRaysPlanesStacked.apply(
            rays_o.detach(), rays_d.detach(), viewdirs.detach(), z_vals.detach(),
            *(kp[n] for n in KP_NAMES))
    kp, blobs = packed_params(mlp, pe_pts, pe_views, compute_dtype)
    return fused_rays_planes_stacked(kp, rays_o, rays_d, viewdirs, z_vals, blobs)


# ------------------------------------------------- stacked (multi-scene) K2/K3
#
# The points-in pair for S scenes (the renderer's query at sample counts
# that are not multiples of 8): points [S, P, 3] and directions [S, P/spr, 3],
# one K2 launch and one K3 launch (its three phases) for every scene's
# points, each tile on its own scene's weights. Weight grads only: the
# renderer's points carry no gradient (nerf_tpu's vmapped fused_query with
# input_grads=False).


def _check_stacked_points(kp, x, v, spr) -> None:
    S = x.shape[0]
    if x.dim() != 3 or v.dim() != 3 or kp["W1"].dim() != 3 or kp["W1"].shape[0] != S \
            or v.shape[0] != S:
        raise ValueError(f"stacked points: x [S, P, 3], v [S, P/spr, 3] and leaves [S, ...]; "
                         f"got x {tuple(x.shape)}, v {tuple(v.shape)} and W1 "
                         f"{tuple(kp['W1'].shape)}")
    _check_points(x.flatten(0, 1), v.flatten(0, 1), spr)
    if x.shape[1] % spr:
        raise ValueError(f"spr={spr} must divide a scene's {x.shape[1]} points")


def fused_points_stacked_reference(kp, x, v, spr: int) -> torch.Tensor:
    """Plain PyTorch version of the stacked K2: K2's plain version applied
    scene by scene, raw [S, P, 4]."""
    return torch.stack([fused_points_reference(_scene(kp, s), x[s], v[s], spr)
                        for s in range(x.shape[0])])


def fused_points_stacked_bwd_reference(kp, x, v, g, spr: int) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the stacked K3: K3's plain version applied
    scene by scene without input grads, grads with kp's stacked shapes."""
    per = [fused_points_bwd_reference(_scene(kp, s), x[s], v[s], g[s], spr, False)[0]
           for s in range(x.shape[0])]
    return {k: torch.stack([gr[k] for gr in per]) for k in per[0]}


def fused_points_stacked(kp, x, v, spr: int, blobs=None) -> torch.Tensor:
    """Raw [S, P, 4] float32 of S scenes from stacked packed params ([S, ...]
    leaves) at points x [S, P, 3], point p of scene s looking along
    v[s, p // spr]: scene s's points through scene s's net. CUDA tensors
    launch the stacked K2 once for every scene (``launches`` counts one a
    launch, whatever S is), each scene's points zero-padded to
    ``_pad_points``; CPU tensors take the plain version. ``blobs`` is
    ``kernel_blobs(kp)`` where the caller keeps it."""
    _check_stacked_points(kp, x, v, spr)
    if x.device.type == "cpu":
        return fused_points_stacked_reference(kp, x, v, spr)
    if x.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {x.device}")
    if is_wide(kp):
        return _wide().fused_points_wide_stacked(kp, x, v, spr, blobs)
    dtype, W, Fp, Fv = _kernel_config(kp, x)
    S, P, _ = x.shape
    P_pad = _pad_points(P, spr)
    xp, vp = _padded((x,), P_pad) + _padded((v,), P_pad // spr)
    out = torch.empty(S, P_pad, 4, dtype=torch.float32, device=x.device)
    lib = _build.load("fused_mlp_fwd")
    wblob, bblob = kernel_blobs(kp) if blobs is None else blobs
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nerf_fused_mlp_fwd_points_stacked(
            int(dtype == torch.bfloat16), W, xp.data_ptr(), vp.data_ptr(), S, P_pad, spr, Fp, Fv,
            wblob.data_ptr(), bblob.data_ptr(), out.data_ptr(), stream,
        )
    _raise_on(lib, err, "fused_mlp_fwd_points_stacked")
    fused_points_stacked.launches += 1
    return out[:, :P]


fused_points_stacked.launches = 0


def stacked_points_workspace_bytes(W: int, n_scenes: int, pts_per_scene: int, spr: int,
                                   bf16: bool = True) -> int:
    """Bytes of device workspace that one stacked K3 launch takes (after
    ``_pad_points``); asks the built library."""
    lib = _build.load("fused_mlp_bwd")
    nbytes = ctypes.c_longlong(0)
    _raise_on(lib, lib.nerf_fused_mlp_bwd_points_stacked_workspace(
        int(bf16), W, n_scenes, _pad_points(pts_per_scene, spr), spr, ctypes.byref(nbytes)),
        "fused_mlp_bwd_points_stacked")
    return nbytes.value


def fused_points_stacked_bwd(kp, x, v, g, spr: int, blobs=None) -> Dict[str, torch.Tensor]:
    """float32 grads of the stacked packed leaves (kp's [S, ...] shapes) from
    the cotangent ``g [S, P, 4]`` of ``fused_points_stacked``'s output: each
    scene's the grads of its own net (no input grads). CUDA tensors launch
    the stacked K3 (its recompute, chain and weight grads once each for
    every scene; ``launches`` counts one); CPU tensors take the plain
    version."""
    _check_stacked_points(kp, x, v, spr)
    S, P, _ = x.shape
    if g.shape != (S, P, 4) or g.dtype != torch.float32 or g.device != x.device:
        raise ValueError(f"g: expected float32 {(S, P, 4)} on {x.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    if x.device.type == "cpu":
        return fused_points_stacked_bwd_reference(kp, x, v, g, spr)
    if x.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {x.device}")
    if is_wide(kp):
        return _wide().fused_points_wide_stacked_bwd(kp, x, v, g, spr, blobs)
    dtype, W, Fp, Fv = _kernel_config(kp, x)
    dev = x.device
    P_pad = _pad_points(P, spr)
    xp, gp = _padded((x, g), P_pad)  # padded points: a zero cotangent
    (vp,) = _padded((v,), P_pad // spr)
    lib = _build.load("fused_mlp_bwd")
    use_bf16 = int(dtype == torch.bfloat16)
    ws, nbytes = _workspace(lib, lib.nerf_fused_mlp_bwd_points_stacked_workspace,
                            "fused_mlp_bwd_points_stacked", use_bf16, W, S, P_pad, spr, dev=dev)
    out = torch.zeros(S, _grad_size(W), dtype=torch.float32, device=dev)
    wblob, bblob = kernel_blobs(kp) if blobs is None else blobs
    wtblob = _chain_blob(kp)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_fused_mlp_bwd_points_stacked(
            use_bf16, W, xp.data_ptr(), vp.data_ptr(), gp.data_ptr(), S, P_pad, spr, Fp, Fv,
            wblob.data_ptr(), wtblob.data_ptr(), bblob.data_ptr(), ws.data_ptr(), nbytes,
            out.data_ptr(), stream,
        )
    _raise_on(lib, err, "fused_mlp_bwd_points_stacked")
    fused_points_stacked_bwd.launches += 1
    bwd_recompute.launches += use_bf16
    bwd_chain.launches += use_bf16
    return _unpack_grads(out, W, Fp, Fv)


fused_points_stacked_bwd.launches = 0


class _FusedPointsStacked(torch.autograd.Function):
    """The stacked K2 forward, the stacked K3 backward over stacked packed
    leaves (KP_NAMES order); the points and directions get no gradient."""

    @staticmethod
    def forward(ctx, x, v, spr, *leaves):
        kp = dict(zip(KP_NAMES, leaves))
        blobs = kernel_blobs(kp) if x.is_cuda else None
        ctx.save_for_backward(x, v, *leaves)
        ctx.blobs, ctx.spr = blobs, spr
        return fused_points_stacked(kp, x, v, spr, blobs)

    @staticmethod
    def backward(ctx, g):
        x, v, *leaves = ctx.saved_tensors
        kp = dict(zip(KP_NAMES, leaves))
        spr = ctx.spr
        grads, _, _ = _points_bwd_sliced(
            lambda xs, vs, gs: (fused_points_stacked_bwd(kp, xs, vs, gs, spr, ctx.blobs), None,
                                None),
            kp, x, v, g.contiguous(), spr, False, dim=1)
        ctx.blobs = None
        return (None,) * 3 + tuple(grads[n].to(kp[n].dtype) for n in KP_NAMES)


def fused_query_stacked(mlp, cfg: MLPConfig, pe_pts: PosEncConfig, pe_views: PosEncConfig,
                        pts: torch.Tensor, viewdirs: torch.Tensor,
                        compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``fused_query`` for a stacked net (render/network.py's
    StackedNeRFMLP) without input grads: points [S, R, N, 3] and view
    directions [S, R, 3] in, raw [S, R, N, 4] out, scene s's through scene
    s's net; the directions per ray (spr = N) where N is a multiple of 8,
    else per point (spr = 1), as fused_query takes them. Points and
    directions get no gradient (the renderer's: nerf_tpu's fused_query with
    input_grads=False)."""
    if not supports_stacked(cfg, pe_pts, pe_views):
        raise ValueError("fused_query_stacked: unsupported MLP / posenc configuration")
    S, R, N, _ = pts.shape
    x = pts.detach().reshape(S, R * N, 3)
    vd = viewdirs.detach()
    if N % 8 == 0 and N > 1:
        v, spr = vd, N
    else:
        v, spr = vd[:, :, None, :].expand(S, R, N, 3).reshape(S, R * N, 3), 1
    if torch.is_grad_enabled() and any(p.requires_grad for p in mlp.parameters()):
        kp = pack_params(mlp, pe_pts, pe_views, compute_dtype)
        _check_stacked_points(kp, x, v, spr)
        out = _FusedPointsStacked.apply(x, v, spr, *(kp[n] for n in KP_NAMES))
    else:
        kp, blobs = packed_params(mlp, pe_pts, pe_views, compute_dtype)
        out = fused_points_stacked(kp, x, v, spr, blobs)
    return out.reshape(S, R, N, 4)
