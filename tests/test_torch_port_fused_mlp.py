"""The port's fused posenc+MLP forward (ops/fused_mlp.py) against nerf_tpu.

On the CPU the wrapper takes the kernel's plain PyTorch version; it is held
to nerf_tpu's Pallas kernel, run in interpret mode as tests/test_fused_mlp.py
runs it. The CUDA kernel itself is checked on the card by
tests/test_torch_port_kernels.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.embedding import PosEncConfig as JPosEnc
from nerf_tpu.models.nerf_mlp import MLPConfig as JMLPConfig
from nerf_tpu.models.nerf_mlp import init_params
from nerf_tpu.ops import fused_mlp as jfused
from nerf_tpu.experimental import fused_render as jfr
from nerf_tpu_torch.experimental import fused_render as tfr
from nerf_tpu_torch.models.convert import jax_params_from_state_dict, state_dict_from_jax_params
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import fused_mlp, fused_mlp_wide

W = 128  # the kernels need a multiple of 128
CFG, JCFG = MLPConfig(width=W), JMLPConfig(width=W)
PE_P, PE_V = PosEncConfig(10), PosEncConfig(4)
JPE_P, JPE_V = JPosEnc(10), JPosEnc(4)
F32_TOL = 1e-5  # tests/test_fused_mlp.py:52-58
BF16_TOL = 0.25  # tests/test_fused_mlp.py:186-194
# bf16 against nerf_tpu's bf16 kernel: the operand rounding is the same, but
# nerf_tpu's bf16 mode evaluates posenc with a polynomial (max error 1.8e-5)
# and the sums run in another order; measured max |diff| 1.8e-4 here.
BF16_MEASURED_TOL = 2e-3
# bf16 activations against nerf_tpu's from the same rounded embeddings: one
# bf16 ulp of the larger side (an f32 sum in another order lands on the other
# side of a rounding edge), plus what such an ulp, carried on through the
# next layers' sums, adds where a value is small; that excess measured up to
# 2.0e-4 here (h4, R=5, S=16).
ROWS_ULP, ROWS_ULP_ATOL = 2.0 ** -7, 2.0 ** -11
# the chain's grads (phase 3's products over its plain rows), dx and dv
# against nerf_tpu's _mlp_backward_math on the same recompute rows and g,
# per-leaf relative L2: f32 sums in another order only (measured up to
# 2.2e-7, W4); in bf16 also a cotangent whose f32 sum lies at a rounding
# edge rounds to the other neighbour, and that ulp moves on through the
# later layers (measured up to 3.9e-6, dx). Bounds ~10x.
CHAIN_JAX_F32_TOL = 2e-6
CHAIN_JAX_BF16_TOL = 4e-5
# f32 grads of the wide configurations against nerf_tpu's Pallas backward,
# relative to each leaf's largest entry: ROADMAP's f32 grad bound (measured
# up to 7.8e-7, dx at W=384, on inputs whose points both packages compute
# alike: _wide_rays)
WIDE_GRAD_TOL = 1e-5


@pytest.fixture(scope="module")
def nets():
    params = jax.tree.map(np.asarray, init_params(jax.random.key(0), JCFG))
    mlp = NeRFMLP(CFG, device="cpu")
    mlp.load_state_dict(state_dict_from_jax_params(params, CFG), strict=True)
    return params, mlp


def _rays(seed, R, S):
    rng = np.random.default_rng(seed)
    ro = (rng.standard_normal((R, 3)) * 0.5).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (R, S)).astype(np.float32), -1)
    return ro, rd, vd, z


def test_pack_params_matches_jax(nets):
    params, mlp = nets
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = jfused.pack_params(params, JCFG, JPE_P, JPE_V, jdt)
        kp = fused_mlp.pack_params(mlp, PE_P, PE_V, tdt)
        assert set(kp) == set(ref) - {"Sp", "Sv"}
        for k, v in kp.items():
            assert v.dtype == (torch.float32 if k.startswith("b") else tdt), k
            np.testing.assert_array_equal(
                v.detach().float().numpy(), np.asarray(ref[k], np.float32), err_msg=k
            )


@pytest.mark.parametrize("R,S", [(5, 16), (3, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_kernel(nets, R, S, dtype):
    params, mlp = nets
    arrays = _rays(R * S, R, S)
    ref = np.asarray(
        jfused.fused_query_rays_planes(
            params, JCFG, JPE_P, JPE_V, *(jnp.asarray(a) for a in arrays),
            compute_dtype=getattr(jnp, dtype),
        )
    )
    before = fused_mlp.fused_rays_planes.launches
    with torch.no_grad():
        out = fused_mlp.fused_query_rays_planes(
            mlp, CFG, PE_P, PE_V, *(torch.from_numpy(a) for a in arrays),
            compute_dtype=getattr(torch, dtype),
        ).numpy()
    assert fused_mlp.fused_rays_planes.launches == before  # CPU: no kernel launch
    assert out.shape == ref.shape == (4, R, S) and out.dtype == np.float32
    err = float(np.abs(out - ref).max())
    if dtype == "float32":
        assert err <= F32_TOL, err
    else:
        assert err <= BF16_TOL and err <= BF16_MEASURED_TOL, err


def test_kernel_blobs_layout(nets):
    """The flat buffers hold each packed block where csrc/fused_mlp_fwd.cu
    looks for it: [out, in] rows, embedding K zero-padded to 64 / 32."""
    _, mlp = nets
    kp = fused_mlp.pack_params(mlp, PE_P, PE_V, torch.float32)
    wb, bb = fused_mlp.kernel_blobs(kp)
    ke, kv = fused_mlp.KE, fused_mlp.KV
    o = 0
    w05 = wb[o : o + 2 * W * ke].reshape(2 * W, ke)
    torch.testing.assert_close(w05[:, :63], kp["W05e"].T, rtol=0, atol=0)
    assert not w05[:, 63:].any()
    o += 2 * W * ke
    for name in [f"W{i}" for i in range(1, 8)] + ["Wf"]:
        torch.testing.assert_close(wb[o : o + W * W].reshape(W, W), kp[name].T, rtol=0, atol=0)
        o += W * W
    torch.testing.assert_close(wb[o : o + W * W // 2].reshape(W // 2, W), kp["Wvf"].T,
                               rtol=0, atol=0)
    o += W * W // 2
    wve = wb[o : o + W // 2 * kv].reshape(W // 2, kv)
    torch.testing.assert_close(wve[:, :27], kp["Wve"].T, rtol=0, atol=0)
    assert not wve[:, 27:].any()
    o += W // 2 * kv
    torch.testing.assert_close(wb[o:].reshape(3 * W // 2, 4), kp["Wout"], rtol=0, atol=0)
    assert bb.shape == (9 * W + W // 2 + 4,)
    torch.testing.assert_close(bb[-4:], kp["bout"][0], rtol=0, atol=0)


def test_flops_per_point():
    assert fused_mlp.flops_per_point(MLPConfig(), PE_P, PE_V) == 1_186_816


def test_wgrad_bytes_per_point():
    # the workspace rows the weight-grad phase reads once: 4,936 bf16 a point
    assert fused_mlp.wgrad_bytes_per_point(MLPConfig()) == 9_872


def test_wgrad_flops():
    # 1,181,696 a point, 6,912 a ray (dWve)
    assert fused_mlp.wgrad_flops(MLPConfig(), PE_P, PE_V, 3, 5) == 15 * 1_181_696 + 3 * 6_912


def test_bwd_tile_flops_and_bytes():
    # phase 1: the recompute and the cotangent chain, 3,484,416 - 1,181,696
    # a point and nothing a ray; with input grads d_e a point, d_ev a ray
    assert fused_mlp.bwd_tile_flops(MLPConfig(), PE_P, PE_V, 3, 5) == 15 * 2_302_720
    assert fused_mlp.bwd_tile_flops(MLPConfig(), PE_P, PE_V, 3, 5, input_grads=True) == \
        15 * (2_302_720 + 64_512) + 3 * 6_912
    # the workspace rows written once (4 of gc's 8), the f32 d_hv rows, g and
    # z; and the relu mask words (272 B), which the recompute writes and the
    # chain reads
    assert fused_mlp.bwd_tile_bytes_per_point(MLPConfig()) == 9_872 - 8 + 512 + 16 + 4 + 2 * 272


def test_recompute_and_chain_flops_and_bytes():
    cfg = MLPConfig()
    # the recompute: W05e's two halves (2 x 63 x 256), W1..W7 and Wf (8 x
    # 256^2), the view layer ((256 + 27) x 128), a multiply-add each
    assert fused_mlp.recompute_flops(cfg, PE_P, PE_V, 3, 5) == 15 * 2 * 592_768
    assert fused_mlp.chain_flops(cfg, PE_P, PE_V, 3, 5) == 15 * (2_302_720 - 1_185_536)
    # masks: h0..h7 and hv, a bit each: (8 x 256 + 128) / 8
    assert fused_mlp.mask_bytes_per_point(cfg) == 272
    # the recompute writes e (64), h0..h7, feat and hv in bf16 and the masks,
    # and reads z
    assert fused_mlp.recompute_bytes_per_point(cfg) == 2 * (64 + 8 * 256 + 256 + 128) + 272 + 4
    assert fused_mlp.recompute_bytes_per_point(cfg) == 5_268
    # the chain writes gc's 4 used rows, d0..d7, d_feat and d_hv in bf16 and
    # d_hv in f32, and reads the masks and g
    assert fused_mlp.chain_bytes_per_point(cfg) == \
        2 * (4 + 8 * 256 + 256 + 128) + 4 * 128 + 272 + 16
    assert fused_mlp.chain_bytes_per_point(cfg) == 5_672
    assert fused_mlp.mask_rows(256) == 68 and fused_mlp.mask_rows(128) == 34


def _clear_points(mlp, R, S, spr, margin=2e-6):
    """(x [R*S, 3], v [R*S/spr, 3]) whose relu inputs all lie further than
    ``margin`` from zero in the f32 forward: the two packages' forwards
    differ by ~1e-6, so a relu input closer to zero than that can fall on
    either side (ROADMAP C.r3)."""
    kp = fused_mlp.pack_params(mlp, PE_P, PE_V, torch.float32)
    for seed in range(100):
        ro, rd, vd, z = _rays(1000 * S + seed, R, S)
        x = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
        v = np.repeat(vd, S, 0) if spr == 1 else vd
        with torch.no_grad():
            e = fused_mlp._embed(torch.from_numpy(x), PE_P.num_freqs)
            z05 = e @ kp["W05e"]
            pre = [z05[:, :W] + kp["b0"]]
            for i in range(1, 8):
                zi = torch.relu(pre[-1]) @ kp[f"W{i}"] + kp[f"b{i}"]
                pre.append(zi + z05[:, W:] if i == 5 else zi)
            feat = torch.relu(pre[-1]) @ kp["Wf"] + kp["bf"]
            ev = fused_mlp._embed(torch.from_numpy(v), PE_V.num_freqs) @ kp["Wve"]
            pre.append(feat @ kp["Wvf"] + ev.repeat_interleave(spr, 0) + kp["bv"])
        if min(float(t.abs().min()) for t in pre) > margin:
            return x, v
    raise AssertionError("no well-conditioned inputs in 100 seeds")


@pytest.mark.parametrize("R,S,spr", [(3, 77, 1), (5, 16, 16)])  # 231 points: ragged
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_recompute_reference_matches_jax(nets, R, S, spr, dtype):
    """The recompute's plain version (the workspace rows and relu mask words
    of the bf16 backward's first launch) against nerf_tpu's embeddings and,
    from the same rounded embeddings, its _trunk_forward(keep_acts=True) and
    _head_forward. (nerf_tpu's bf16 posenc is a polynomial whose 1.8e-5
    error rounds a few embedding entries to the other bf16 neighbour, which
    moves some relu inputs across zero: the embeddings are compared apart.)"""
    params, mlp = nets
    x, v = _clear_points(mlp, R, S, spr)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, PE_P, PE_V, tdt)
        got = fused_mlp.bwd_recompute(kp, torch.from_numpy(x), torch.from_numpy(v), spr, raw=True)
    jkp = jfused.pack_params(params, JCFG, JPE_P, JPE_V, jdt)
    e, _, _ = jfused._embed_pts(jnp.asarray(x), jkp, jdt)
    ev, _, _ = jfused._embed_views(jnp.asarray(v), jkp, jdt)
    same = lambda t, n: jnp.asarray(t[:n].T.float().numpy()).astype(jdt)  # noqa: E731
    h, acts = jfused._trunk_forward(same(got.rows["e"], 63), jkp, jdt, keep_acts=True)
    raw, feat, hv = jfused._head_forward(h, same(got.rows["ev"], 27), jkp, jdt, W, spr)
    want = {"e": e, "ev": ev, **{f"h{i}": a for i, a in enumerate(acts)},
            "feat": feat.astype(jdt), "hv": hv.astype(jdt)}
    assert len(acts) == 8 and got.masks.shape == (fused_mlp.mask_rows(W), R * S)
    for name, ref in want.items():
        ref = np.asarray(ref.astype(jnp.float32))
        row = got.rows[name].float().numpy()
        assert row.shape[0] == {"e": fused_mlp.KE, "ev": fused_mlp.KV, "hv": W // 2}.get(name, W)
        assert not row[ref.shape[1]:].any(), name  # the embeddings' padding rows
        d = np.abs(row[: ref.shape[1]].T - ref)
        if dtype == "float32":
            assert float(d.max()) <= F32_TOL, (name, float(d.max()))
        elif name in ("e", "ev"):  # nerf_tpu's polynomial posenc
            assert float(d.max()) <= BF16_TOL, (name, float(d.max()))
        else:  # the layers, from the port's own rounded embeddings
            excess = d - ROWS_ULP * np.maximum(np.abs(row[: ref.shape[1]].T), np.abs(ref))
            assert float(excess.max()) <= ROWS_ULP_ATOL, (name, float(excess.max()))
    tol = F32_TOL if dtype == "float32" else BF16_MEASURED_TOL
    np.testing.assert_allclose(got.raw.numpy(), np.asarray(raw), rtol=0, atol=tol)
    # the mask words decode to nerf_tpu's relu masks, bit for bit
    for i, a in enumerate(acts):
        bits = fused_mlp.unpack_mask_bits(got.masks[i * (W // 32) : (i + 1) * (W // 32)], W)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(a.astype(jnp.float32)) > 0)
    bits = fused_mlp.unpack_mask_bits(got.masks[8 * (W // 32) :], W // 2)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(hv) > 0)


@pytest.mark.parametrize("spr", [1, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recompute_layers_reference_reads_the_rows_given(nets, spr, dtype):
    """Fed the plain chain's own rows, each layer gives them back bit for bit
    (columns past N, as a kernel's padded tile leaves them, are ignored);
    fed a row that differs, only the layer that reads it follows."""
    _, mlp = nets
    rng = np.random.default_rng(spr)
    x = torch.from_numpy(rng.standard_normal((16 * 13, 3)).astype(np.float32))
    v = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((16 * 13 // spr, 3)).astype(np.float32)), dim=-1)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
        ref = fused_mlp.bwd_recompute_reference(kp, x, v, spr).rows
        padded = {k: torch.nn.functional.pad(t, (0, 48), value=float("nan"))
                  for k, t in ref.items() if k != "ev" or spr == 1}
        lay = fused_mlp.recompute_layers_reference(kp, padded, x, v, spr)
        assert sorted(lay) == sorted(ref)
        for name, rows in ref.items():
            assert torch.equal(lay[name], rows), name
        padded["h3"] = padded["h3"] * 2
        moved = fused_mlp.recompute_layers_reference(kp, padded, x, v, spr)
    assert not torch.equal(moved["h4"], ref["h4"])
    assert all(torch.equal(moved[k], ref[k]) for k in ref if k != "h4")


def test_mask_bits_round_trip():
    rng = np.random.default_rng(3)
    bits = torch.from_numpy(rng.random((37, 100)) > 0.5)
    words = fused_mlp.pack_mask_bits(bits)
    assert words.shape == (4, 37) and words.dtype == torch.int32
    assert torch.equal(fused_mlp.unpack_mask_bits(words, 100), bits)
    # bit 31 of a word is the sign of its int32
    assert int(fused_mlp.pack_mask_bits(torch.eye(32, dtype=torch.bool)[31:])[0, 0]) == -2**31


@pytest.mark.parametrize("width,want", [(256, 1_190_912), (128, 316_928)])
def test_fwd_weight_bytes_per_tile(width, want):
    # the bf16 blob that the forward streams once per 128-point tile:
    # Layout<W> up to Wout, then Wout's 3W/2 x 4, in bf16
    cfg = MLPConfig(width=width)
    assert fused_mlp.fwd_weight_bytes_per_tile(cfg) == want
    kp = fused_mlp.pack_params(NeRFMLP(cfg, seed=width, device="cpu"), PE_P, PE_V, torch.bfloat16)
    wb, _ = fused_mlp.kernel_blobs(kp)
    assert wb.dtype == torch.bfloat16 and wb.numel() * wb.element_size() == want


def test_wrapper_checks(nets):
    _, mlp = nets
    kp = fused_mlp.pack_params(mlp, PE_P, PE_V, torch.float32)
    ro, rd, vd, z = (torch.from_numpy(a) for a in _rays(0, 2, 8))
    with pytest.raises(ValueError, match="z_vals"):
        fused_mlp.fused_rays_planes(kp, ro, rd, vd, z.double())
    with pytest.raises(ValueError, match="device"):
        fused_mlp.fused_rays_planes(kp, *(t.to("meta") for t in (ro, rd, vd, z)))
    # under autograd the fused query differentiates (through K4's plain version here)
    out = fused_mlp.fused_query_rays_planes(mlp, CFG, PE_P, PE_V, ro, rd, vd, z)
    assert out.requires_grad
    with pytest.raises(ValueError, match="g_planes"):
        fused_mlp.fused_rays_planes_bwd(kp, ro, rd, vd, z, torch.zeros(4, 2, 7))
    assert fused_mlp.supports(MLPConfig(width=W), PE_P, PE_V)
    assert not fused_mlp.supports(MLPConfig(width=W, use_viewdirs=False), PE_P, PE_V)
    assert not fused_mlp.supports(MLPConfig(width=96), PE_P, PE_V)
    # a multiple of 128 that the tile is not built for, or more octaves: the
    # wide family's (nerf_tpu's guard), inside the stacked kernels' guard
    # too (the stacked wide plans)
    for cfg, pe_p, pe_v in ((MLPConfig(width=384), PE_P, PE_V), (CFG, PosEncConfig(11), PE_V),
                            (CFG, PE_P, PosEncConfig(5))):
        assert fused_mlp.supports(cfg, pe_p, pe_v)
        assert fused_mlp.supports_stacked(cfg, pe_p, pe_v)
        assert not fused_mlp.tile_supports(cfg.width, pe_p.num_freqs, pe_v.num_freqs)


def test_packed_params_kept_until_a_parameter_changes():
    mlp = NeRFMLP(CFG, seed=3, device="cpu")
    kp, blobs = fused_mlp.packed_params(mlp, PE_P, PE_V, torch.bfloat16)
    assert blobs is None  # the flat buffers are built for the card only
    assert fused_mlp.packed_params(mlp, PE_P, PE_V, torch.bfloat16)[0] is kp
    assert fused_mlp.packed_params(mlp, PE_P, PE_V, torch.float32)[0]["W1"].dtype == torch.float32
    other = NeRFMLP(CFG, seed=4, device="cpu")
    mlp.load_state_dict(other.state_dict())
    kp2, _ = fused_mlp.packed_params(mlp, PE_P, PE_V, torch.bfloat16)
    ref = fused_mlp.pack_params(other, PE_P, PE_V, torch.bfloat16)
    assert kp2 is not kp
    for k, v in ref.items():
        torch.testing.assert_close(kp2[k], v, rtol=0, atol=0)


def _chain_case(mlp, spr, dtype, input_grads=False, seed=0):
    """(kp, x, v, g, the recompute's and the chain's plain rows) on 208
    points (a ragged last 64-point part), g one-signed as a loss's."""
    rng = np.random.default_rng(seed + spr)
    x = torch.from_numpy(rng.standard_normal((16 * 13, 3)).astype(np.float32))
    v = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((16 * 13 // spr, 3)).astype(np.float32)), dim=-1)
    g = torch.from_numpy(((0.5 + rng.random((16 * 13, 4))) * 1e-2).astype(np.float32))
    before = fused_mlp.bwd_chain.launches
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, PE_P, PE_V, dtype)
        rec, chain = fused_mlp.bwd_chain(kp, x, v, spr, g, input_grads)  # CPU: the plain versions
    assert fused_mlp.bwd_chain.launches == before and rec.raw is None
    return kp, x, v, g, rec, chain


def _atd(kp, rec, chain, spr):
    """Every weight grad as the backward's phase 3 takes it, aᵀd over the
    rows (make_probs in csrc/fused_mlp_bwd.cu), and the bias grads as the
    sums of the parts (reduce_tiles)."""
    W = kp["W1"].shape[0]
    ep, ev = kp["W05e"].shape[0], kp["Wve"].shape[0]
    r, d = rec.rows, chain.rows
    dhv_ray = fused_mlp.round_to(chain.dhv32.reshape(-1, spr, W // 2).sum(1), kp["W1"].dtype)
    grads = {"W05e": r["e"][:ep] @ torch.cat([d["d0"], d["d5"]]).T,
             **{f"W{i}": r[f"h{i - 1}"] @ d[f"d{i}"].T for i in range(1, 8)},
             "Wf": r["h7"] @ d["dfeat"].T, "Wvf": r["feat"] @ d["dhv"].T,
             "Wve": r["ev"][:ev] @ dhv_ray if "ev" in r else None,
             "Wout": torch.cat([r["hv"] @ d["gc"].T, r["h7"] @ d["gc"].T])}
    grads.update({k: t.sum(0, keepdim=True) for k, t in chain.bias.items()})
    return grads


@pytest.mark.parametrize("spr", [1, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_layers_reference_reads_the_rows_given(nets, spr, dtype):
    """Fed the plain chain's own rows and the recompute's mask words (columns
    past N, as a kernel's padded tile leaves them, ignored), each block's
    one product gives the rows, the f32 d_hv, the bias parts and the input
    grads back bit for bit; fed a row that differs, only the block whose
    product reads it follows."""
    _, mlp = nets
    kp, x, v, g, rec, chain = _chain_case(mlp, spr, dtype, input_grads=True)
    pad = lambda t, value: torch.nn.functional.pad(t, (0, 48), value=value)  # noqa: E731
    rows = {k: pad(t, float("nan")) for k, t in chain.rows.items()}
    masks = pad(rec.masks, -1)
    with torch.no_grad():
        lay = fused_mlp.chain_layers_reference(kp, rows, masks, g, spr, x, v)
        assert sorted(lay.rows) == sorted(chain.rows) == sorted(fused_mlp.chain_ws_rows(128))
        for name, t in chain.rows.items():
            assert torch.equal(lay.rows[name], t), name
        assert torch.equal(lay.dhv32, chain.dhv32)
        for name, t in chain.bias.items():
            assert t.shape == (4, t.shape[1]) and torch.equal(lay.bias[name], t), name
        assert torch.equal(lay.dx, chain.dx)
        assert (lay.dv is None) == (spr > 1) and (spr > 1 or torch.equal(lay.dv, chain.dv))
        rows["d3"] = rows["d3"] * 2
        moved = fused_mlp.chain_layers_reference(kp, rows, masks, g, spr)
    assert not torch.equal(moved.rows["d2"], chain.rows["d2"])
    assert all(torch.equal(moved.rows[k], chain.rows[k]) for k in chain.rows if k != "d2")


@pytest.mark.parametrize("spr", [1, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_rows_give_the_backward_grads(nets, spr, dtype):
    """Phase 3's products aᵀd over the recompute's and the chain's plain rows,
    and the sums of the chain's bias parts, are the plain backward's grads
    (up to the f32 sums' order), and its dx and dv the chain's."""
    _, mlp = nets
    kp, x, v, g, rec, chain = _chain_case(mlp, spr, dtype, input_grads=True)
    with torch.no_grad():
        want, dx, dv = fused_mlp._backward(kp, x, v, spr, g, True)
    got = _atd(kp, rec, chain, spr)
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        ref = got[name] if got[name] is not None else None
        if name == "Wve" and spr > 1:  # per ray: ev's rows are the ray_prep launch's
            continue
        torch.testing.assert_close(ref, t, rtol=1e-5, atol=1e-6 * float(t.abs().max()), msg=name)
    assert torch.equal(dx, chain.dx) and torch.equal(dv, chain.dv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_chain_reference_matches_jax(nets, dtype):
    """The chain's plain rows, through phase 3's products, against nerf_tpu's
    _mlp_backward_math fed the port's own recompute rows (embeddings
    included: nerf_tpu's bf16 posenc is a polynomial) and the same g: the
    weight and bias grads, dx and dv. A ragged 231 points, a direction per
    point."""
    params, mlp = nets
    R, S, spr = 3, 77, 1
    x, v = _clear_points(mlp, R, S, spr)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    g = ((0.5 + np.random.default_rng(7).random((R * S, 4))) * 1e-2).astype(np.float32)
    xt, vt, gt = torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(g)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, PE_P, PE_V, tdt)
        rec = fused_mlp.bwd_recompute_reference(kp, xt, vt, spr)
        chain = fused_mlp.bwd_chain_reference(kp, xt, vt, spr, gt, input_grads=True)
    got = _atd(kp, rec, chain, spr)
    jkp = jfused.pack_params(params, JCFG, JPE_P, JPE_V, jdt)
    _, sp, cp = jfused._embed_pts(jnp.asarray(x), jkp, jdt)
    _, sv, cv = jfused._embed_views(jnp.asarray(v), jkp, jdt)
    same = lambda t, n: jnp.asarray(t[:n].T.float().numpy()).astype(jdt)  # noqa: E731
    e, ev = same(rec.rows["e"], 63), same(rec.rows["ev"], 27)
    h, acts = jfused._trunk_forward(e, jkp, jdt, keep_acts=True)
    _, feat, hv = jfused._head_forward(h, ev, jkp, jdt, W, spr)
    accs, jdx, jdv = jfused._mlp_backward_math(jkp, jdt, W, 10, 4, spr, e, sp, cp, ev, sv, cv,
                                               acts, h, feat, hv, jnp.asarray(g))
    tol = CHAIN_JAX_F32_TOL if dtype == "float32" else CHAIN_JAX_BF16_TOL
    for name, t in got.items():
        ref = np.asarray(accs[f"d{name}"], np.float32)
        err = float(np.linalg.norm(t.numpy()[: ref.shape[0]] - ref) / np.linalg.norm(ref))
        assert err <= tol, (name, err)
    for t, ref in ((chain.dx, jdx), (chain.dv, jdv)):
        ref = np.asarray(ref, np.float32)
        err = float(np.linalg.norm(t.numpy() - ref) / np.linalg.norm(ref))
        assert err <= tol, err


# ------------------------------------- the wide family (ROADMAP C.3)
#
# Configurations nerf_tpu's kernels take and the W <= 256 tile does not: a
# width whose half is not a multiple of 128, and mip-NeRF's 16 point (and 6
# view) octaves, 3 + 6·16 = 99 embedding columns, beyond the tile's 64. On
# the CPU the wrappers take the same plain versions as for the tile's
# configurations; ops/fused_mlp_wide.py's launch plan is held to them with
# its primitives' plain versions (PlainOps); the kernels themselves on the
# card (tests/test_torch_port_kernels.py).
WIDE = {"W384-10-4": (384, 10, 4), "W128-16-6": (128, 16, 6)}


@functools.lru_cache(maxsize=None)
def _wide_params(jcfg, seed):
    return jax.tree.map(np.asarray, init_params(jax.random.key(seed), jcfg))


def _wide_nets(W_, fp, fv, seed=0):
    """nerf_tpu's params (made once a process) and a fresh port net of one
    wide configuration."""
    jcfg = JMLPConfig(width=W_, input_ch=3 + 6 * fp, input_ch_views=3 + 6 * fv)
    cfg = MLPConfig(width=W_, input_ch=3 + 6 * fp, input_ch_views=3 + 6 * fv)
    params = _wide_params(jcfg, seed)
    mlp = NeRFMLP(cfg, device="cpu")
    mlp.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return params, mlp, (jcfg, JPosEnc(fp), JPosEnc(fv)), (cfg, PosEncConfig(fp), PosEncConfig(fv))


def _min_preactivation(kp, x, v, spr):
    """The smallest |input| of any relu of the f32 forward (ROADMAP C.r3)."""
    Fp, Fv = fused_mlp._num_freqs(kp)
    Wn = kp["W1"].shape[0]
    with torch.no_grad():
        z05 = fused_mlp._embed(x, Fp) @ kp["W05e"]
        pre = [z05[:, :Wn] + kp["b0"]]
        for i in range(1, 8):
            zi = torch.relu(pre[-1]) @ kp[f"W{i}"] + kp[f"b{i}"]
            pre.append(zi + z05[:, Wn:] if i == 5 else zi)
        feat = torch.relu(pre[-1]) @ kp["Wf"] + kp["bf"]
        ev = fused_mlp._embed(v, Fv) @ kp["Wve"]
        pre.append(feat @ kp["Wvf"] + ev.repeat_interleave(spr, 0) + kp["bv"])
    return min(float(t.abs().min()) for t in pre)


def _wide_rays(mlp, pe, R, S, margin=2e-6):
    """Rays whose relu inputs all lie further than ``margin`` from zero:
    the packages' f32 forwards differ by ~1e-6 (ROADMAP C.r3). Origins,
    directions and depths lie on grids (2^-10, 2^-10, 2^-8) that make
    x = o + d·z exact in f32, so both packages see the same points whether
    or not the multiply and add contract into an FMA: at 16 octaves a 1-ulp
    move of x turns the top phase x·2^15 by ~2e-3 rad and raw by ~1e-4
    (ROADMAP C.r2's sensitivity, 2^6 times the tile's)."""
    kp = fused_mlp.pack_params(mlp, pe[1], pe[2], torch.float32)
    for seed in range(100):
        ro, rd, _, z = _rays(100 * S + seed, R, S)
        ro, rd = (np.round(a * 1024) / 1024 for a in (ro, rd))
        z = np.round(z * 256) / 256
        vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
        arrays = tuple(a.astype(np.float32) for a in (ro, rd, vd, z))
        ro, rd, vd, z = (torch.from_numpy(a) for a in arrays)
        if _min_preactivation(kp, fused_mlp._ray_points(ro, rd, z), vd, S) > margin:
            return arrays
    raise AssertionError("no well-conditioned inputs in 100 seeds")


def _supports_grid():
    for width in (64, 128, 192, 256, 384, 512, 1024):
        for fp in (1, 4, 10, 12, 16, 20):
            for fv in (1, 4, 6, 10):
                yield dict(width=width), fp, fv, {}, {}
    for kw in (dict(depth=6), dict(skips=(3,)), dict(skips=()), dict(use_viewdirs=False)):
        for width in (256, 512):
            yield kw, 10, 4, {}, {}
    for pkw, vkw in ((dict(include_input=False), {}), ({}, dict(log_sampling=False)),
                     (dict(num_freqs=0), {}), ({}, dict(num_freqs=0))):
        yield dict(width=384), 10, 4, pkw, vkw


def test_supports_equals_nerf_tpu_over_the_grid():
    """The single-scene guards (K1-K6 and their wide family) are nerf_tpu's:
    any width % 128 == 0, any octave count > 0, depth 8, skip at 4,
    viewdirs, included inputs and log sampling; and without view
    directions none."""
    n = 0
    for kw, fp, fv, pkw, vkw in _supports_grid():
        t = MLPConfig(**kw)
        j = JMLPConfig(**kw)
        tp, tv = PosEncConfig(**{"num_freqs": fp, **pkw}), PosEncConfig(**{"num_freqs": fv, **vkw})
        jp, jv = JPosEnc(**{"num_freqs": fp, **pkw}), JPosEnc(**{"num_freqs": fv, **vkw})
        want = jfused.supports(j, jp, jv)
        assert fused_mlp.supports(t, tp, tv) == want, (kw, fp, fv, pkw, vkw)
        for S in (64, 63):
            assert tfr.supports(t, tp, tv, S) == jfr.supports(j, jp, jv, S), (kw, fp, fv, S)
        assert not fused_mlp.supports(t, tp, None) and not jfused.supports(j, jp, None)
        n += want
    assert n == 5 * 6 * 4  # the five multiples of 128 at every octave count, no variant


def test_stacked_guard_is_nerf_tpus_guard():
    """The stacked (multi-scene) kernels' guard is the single-scene one,
    nerf_tpu's (it vmaps its kernels over the scenes): the tile's stacked
    launches inside the tile's limits (W in {128, 256}, at most 64 point and
    32 view embedding columns: 10 and 4 octaves), the wide family's stacked
    plans beyond them (ROADMAP C.3b)."""
    for width in (128, 256, 384, 512):
        for fp in (4, 10, 11, 16):
            for fv in (2, 4, 5, 6):
                cfg, pp, pv = MLPConfig(width=width), PosEncConfig(fp), PosEncConfig(fv)
                tile = width in (128, 256) and fp <= 10 and fv <= 4
                assert fused_mlp.supports_stacked(cfg, pp, pv) == fused_mlp.supports(cfg, pp, pv)
                assert tfr.supports_stacked(cfg, pp, pv, 64) == tfr.supports(cfg, pp, pv, 64)
                assert fused_mlp.supports_stacked(cfg, pp, pv), (width, fp, fv)
                assert fused_mlp.tile_supports(width, fp, fv) == tile
    assert fused_mlp.embed_pad(10, 4) == (fused_mlp.KE, fused_mlp.KV)
    assert fused_mlp.embed_pad(16, 6) == (128, 64) and fused_mlp.embed_pad(1, 1) == (64, 32)


@pytest.mark.parametrize("config", list(WIDE))
def test_wide_blobs_and_params_round_trip(config):
    """At the configuration's KE / KV: the kernel blobs hold every packed
    block ([out, in] rows, embedding K zero-padded), as the wide launches
    read them; the grads' layout unpacks to kp's shapes; the weights carry
    across from nerf_tpu's pytree and back (models/convert.py)."""
    W_, fp, fv = WIDE[config]
    params, mlp, (jcfg, _, _), (cfg, pe_p, pe_v) = _wide_nets(W_, fp, fv)
    back = jax_params_from_state_dict(mlp.state_dict(), cfg)
    for (name, a), b in zip(jax.tree_util.tree_leaves_with_path(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(name))
    kp = fused_mlp.pack_params(mlp, pe_p, pe_v, torch.float32)
    jkp = jfused.pack_params(params, jcfg, JPosEnc(fp), JPosEnc(fv), jnp.float32)
    for k, v in kp.items():
        np.testing.assert_array_equal(v.detach().numpy(), np.asarray(jkp[k]), err_msg=k)
    ke, kv = fused_mlp.embed_pad(fp, fv)
    ep, ev = 3 + 6 * fp, 3 + 6 * fv
    wb, bb = fused_mlp.kernel_blobs(kp)
    w, b = fused_mlp_wide._blocks(kp, (wb, bb))
    assert wb.numel() == 2 * W_ * ke + 8 * W_ * W_ + W_ // 2 * (W_ + kv) + 6 * W_
    assert torch.equal(w["w05"][:, :ep], kp["W05e"].T) and not w["w05"][:, ep:].any()
    for i in range(1, 8):
        assert torch.equal(w[f"w{i}"], kp[f"W{i}"].T)
    assert torch.equal(w["wf"], kp["Wf"].T) and torch.equal(w["wvf"], kp["Wvf"].T)
    assert torch.equal(w["wve"][:, :ev], kp["Wve"].T) and not w["wve"][:, ev:].any()
    for name in [f"b{i}" for i in range(8)] + ["bf", "bv", "bout"]:
        assert torch.equal(b[name], kp[name][0]), name
    assert torch.equal(wb[-6 * W_:].view(-1, 4), kp["Wout"])
    chain = fused_mlp._chain_blob(kp)
    assert chain.numel() == 8 * W_ * W_ + W_ * W_ // 2 + 2 * ke * W_ + kv * W_ // 2
    # the f32 grads' layout: each leaf's block where _grad_blocks puts it
    weights, biases = fused_mlp._grad_blocks(W_, ke, kv)
    flat, leaves = [], {}
    for name, r, c in weights:
        t = torch.randn(r, c)
        flat.append(t.reshape(-1))
        leaves[name] = t[: {"W05e": ep, "Wve": ev}.get(name, r)]
    for name, n in biases:
        t = torch.randn(n)
        flat.append(t)
        leaves[name] = t[None]
    got = fused_mlp._unpack_grads(torch.cat(flat), W_, fp, fv)
    for name, t in got.items():
        assert t.shape == kp[name].shape and torch.equal(t, leaves[name]), name
    probs = fused_mlp_wide._problems(W_, ke, kv, dense=False)
    # each weight grad one whole product, with its cluster
    assert sum(q[2] * q[4] for q in probs) == fused_mlp_wide._grad_offsets(W_, ke, kv)[1]
    assert all(q[7:] == fused_mlp_wide.cluster_shape(q[2], q[4]) for q in probs)
    rows = fused_mlp.ws_rows(W_, ke, kv)[1]
    assert all(q[1] + q[2] <= rows for q in probs if q[0] == 0)


def _wgrad_launch(probs, split_len, k_lens, scenes):
    """A model of csrc/wgrad_sm90.cuh's bf16 launch (``launch_wgrad_bf16``'s
    layout and ``wgrad_bf16``'s place, boxes and arrivals): the launch's
    cluster size and, for each CTA (x, scene), None past the last problem
    or its (problem, split, mi, ni, rank, A and B boxes it issues with their
    receivers' ranks, the ranks its consumer warps free, its full barrier's
    bytes, its empty barrier's arrivals)."""
    wm, wn = fused_mlp_wide.WG_M, fused_mlp_wide.WG_N
    tiles = lambda q: (-(-q[2] // wm), -(-q[4] // wn))  # noqa: E731
    wgs = lambda M, mi: 2 if M - mi * wm > 64 else 1  # noqa: E731
    order = sorted(range(len(probs)), key=lambda i: -probs[i][7] * probs[i][8])  # stable
    starts, cta, cl = [], 0, 1
    for i in order:
        mt, nt = tiles(probs[i])
        starts.append(cta)
        cta += mt * nt * -(-k_lens[i] // split_len)
        cl = max(cl, probs[i][7] * probs[i][8])
    grid = -(-cta // cl) * cl
    ctas = {}
    for x in range(grid):
        j = max(k for k in range(len(order)) if starts[k] <= x)
        pi, local = order[j], x - starts[j]
        q = probs[pi]
        M, N, mc, nc = q[2], q[4], q[7], q[8]
        mt, nt = tiles(q)
        nsplit = -(-k_lens[pi] // split_len)
        for scene in range(scenes):
            if local >= nsplit * mt * nt:
                ctas[x, scene] = None
                continue
            ci, r = divmod(local, mc * nc)
            cm, cn = r % mc, r // mc
            cpm, per = mt // mc, (mt // mc) * (nt // nc)
            split, m0, n0 = ci // per, ci % per % cpm * mc, ci % per // cpm * nc
            mi, ni = m0 + cm, n0 + cn
            first = x % cl - r
            cols = min(wn, N - ni * wn)
            bn = 8 if cols <= 8 else 128 if cols <= 128 else 256
            bboxes = 1 if bn == 8 else bn // 64
            nwg = wgs(M, mi)
            row = [first + cm + mc * n for n in range(nc)]
            col = [first + m + mc * cn for m in range(mc)]
            frees = nc * nwg + sum(wgs(M, m0 + m) for m in range(mc) if m != cm)
            ctas[x, scene] = dict(
                key=(pi, split, mi, ni), rank=x % cl, launch_cluster=x // cl, cluster=(pi, ci),
                a=[(i, row) for i in range(cn, nwg, nc)], b=[(j, col) for j in range(cm, bboxes, mc)],
                frees=row + [c for c in col if c != first + cm + mc * cn], warps=4 * nwg,
                bytes=nwg * 8192 + (1024 if bn == 8 else bboxes * 8192), empty=4 * frees,
                want=(nwg, bboxes, 1024 if bn == 8 else 8192))
    return cl, ctas


@pytest.mark.parametrize("scenes", [1, 3])
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("width", [128, 256, 384, 512, 1024])
def test_wgrad_clusters_cover_each_tile_once(width, dense, scenes):
    """The bf16 weight grads' whole products, their splits and the cluster
    grid (``_wgrad_launch``, the launcher's model) give every (scene,
    problem, split, M-tile, N-tile) of C one CTA; each cluster lies in one
    of the launch's clusters and sums one split; every CTA receives each of
    its A and B boxes once, as many bytes as its full barrier expects; and
    every stage's empty barrier counts the consumer warps that free it,
    among them those of every CTA whose producer writes into it."""
    ke, kv = fused_mlp.embed_pad(10, 4)
    spr = 1 if dense else 4
    n_pad = 256 * 179  # a scene's columns: 716 chunks in splits, the last short
    probs = fused_mlp_wide._problems(width, ke, kv, dense)
    split_len, nsplit = fused_mlp_wide._splits(True, probs, n_pad)
    assert nsplit > 1 and n_pad % split_len
    k_lens = [n_pad // spr if q[0] else n_pad for q in probs]
    cl, ctas = _wgrad_launch(probs, split_len, k_lens, scenes)
    assert cl == {128: 1, 256: 2, 384: 2, 512: 8, 1024: 8}[width]
    live = {k: c for k, c in ctas.items() if c is not None}
    want = {(s, pi, sp, mi, ni) for s in range(scenes) for pi, q in enumerate(probs)
            for sp in range(-(-k_lens[pi] // split_len)) for mi in range(-(-q[2] // 128))
            for ni in range(-(-q[4] // 256))}
    got = [(s,) + c["key"] for (x, s), c in live.items()]
    assert len(got) == len(set(got)) and set(got) == want
    assert len(ctas) - len(live) < cl * scenes  # padding only in the last launch cluster
    by_rank = {}
    for (x, s), c in live.items():
        by_rank[c["launch_cluster"], s, c["rank"]] = c
    members = {}
    for (x, s), c in live.items():
        members.setdefault((s, c["cluster"]), []).append(c)
    for group in members.values():
        assert len({c["launch_cluster"] for c in group}) == 1
        assert len({c["key"][:2] for c in group}) == 1  # one problem, one split
    for s in range(scenes):
        got_a, got_b, frees, writers = {}, {}, {}, {}
        for (x, sc), c in live.items():
            if sc != s:
                continue
            lc = c["launch_cluster"]
            for i, dst in c["a"]:
                for r in dst:
                    got_a.setdefault((lc, r), []).append((c["key"][2], i))
                    writers.setdefault((lc, r), set()).add(c["rank"])
            for j, dst in c["b"]:
                for r in dst:
                    got_b.setdefault((lc, r), []).append((c["key"][3], j))
                    writers.setdefault((lc, r), set()).add(c["rank"])
            for r in c["frees"]:
                frees.setdefault((lc, r), []).append((c["rank"], c["warps"]))
        for (x, sc), c in live.items():
            if sc != s:
                continue
            at = (c["launch_cluster"], c["rank"])
            nwg, bboxes, bbox = c["want"]
            _, _, mi, ni = c["key"]
            assert sorted(got_a.get(at, [])) == [(mi, i) for i in range(nwg)]
            assert sorted(got_b.get(at, [])) == [(ni, j) for j in range(bboxes)]
            assert nwg * 8192 + bboxes * bbox == c["bytes"]
            assert sum(w for _, w in frees.get(at, [])) == c["empty"]
            assert writers[at] <= {r for r, _ in frees[at]}


@pytest.mark.parametrize("config", list(WIDE))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_launch_plan_matches_plain_versions(config, dtype):
    """ops/fused_mlp_wide.py's launch plans (K1w, K2w, K4w and K3w: the
    layers as GEMMs over feature-major rows, the chain, the per-ray sums,
    d_e and d_ev, the weight grads over the workspace rows) run on their
    primitives' plain versions (PlainOps) give the kernels' plain versions:
    raw within f32 ulps (bf16: the same roundings, so bit for bit), the
    grads, dx and dv within the sums' order, in both view modes."""
    W_, fp, fv = WIDE[config]
    _, mlp, _, (cfg, pe_p, pe_v) = _wide_nets(W_, fp, fv)
    ops = fused_mlp_wide.PlainOps()
    R, S = 4, 8
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, pe_p, pe_v, dtype)
        assert fused_mlp.is_wide(kp)
        ro, rd, vd, z = (torch.from_numpy(a) for a in _rays(9, R, S))
        x = fused_mlp._ray_points(ro, rd, z)
        rel = 1e-5 if dtype == torch.float32 else 5e-3
        out = fused_mlp_wide.rays_planes(ops, kp, ro, rd, vd, z)
        ref = fused_mlp.fused_rays_planes_reference(kp, ro, rd, vd, z)
        assert float((out - ref).abs().max()) <= (F32_TOL if dtype == torch.float32 else 0)
        g = (0.5 + torch.rand(4, R, S, generator=torch.Generator().manual_seed(1))) * 1e-2
        got = fused_mlp_wide.rays_planes_bwd(ops, kp, ro, rd, vd, z, g)
        want = fused_mlp.fused_rays_planes_bwd_reference(kp, ro, rd, vd, z, g)
        for name in fused_mlp.KP_NAMES:
            err = float((got[name] - want[name]).norm() / want[name].norm())
            assert got[name].shape == kp[name].shape and err <= rel, (name, err)
        for spr in (1, S):
            v = vd if spr > 1 else vd.repeat_interleave(S, 0)
            out = fused_mlp_wide.points_raw(ops, kp, x, v, spr)
            ref = fused_mlp.fused_points_reference(kp, x, v, spr)
            assert float((out - ref).abs().max()) <= (F32_TOL if dtype == torch.float32 else 0)
            gp = g.reshape(4, -1).T.contiguous()
            got, dx, dv = fused_mlp_wide.points_bwd(ops, kp, x, v, gp, spr, True)
            want, dxr, dvr = fused_mlp.fused_points_bwd_reference(kp, x, v, gp, spr, True)
            errs = {n: float((got[n] - want[n]).norm() / want[n].norm()) for n in want}
            errs.update(dx=float((dx - dxr).norm() / dxr.norm()),
                        dv=float((dv - dvr).norm() / dvr.norm()))
            assert max(errs.values()) <= rel, (spr, errs)


@pytest.mark.parametrize("config", list(WIDE))
def test_wide_plain_versions_match_jax_kernels(config):
    """K1/K4 (raygen, 4 rays x 8 samples) and K2/K3 (points, 4 x 7, a
    direction per point, with input grads) at a wide configuration: the
    port's plain versions, which the CPU wrappers run, against nerf_tpu's
    Pallas kernels in interpret mode, f32: raw within 1e-5 and each grad
    within WIDE_GRAD_TOL of its leaf's largest entry (dx, dv: of their
    largest)."""
    W_, fp, fv = WIDE[config]
    params, mlp, (jcfg, jpp, jpv), (cfg, pe_p, pe_v) = _wide_nets(W_, fp, fv, seed=3)
    R = 4
    for S in (8, 7):
        ro, rd, vd, z = _wide_rays(mlp, (cfg, pe_p, pe_v), R, S)
        g = ((0.5 + np.random.default_rng(S).random((4, R, S))) * 1e-2).astype(np.float32)
        mlp.zero_grad()
        if S == 8:  # K1 / K4
            def jf(p):
                return jfused.fused_query_rays_planes(p, jcfg, jpp, jpv,
                                                      *(jnp.asarray(a) for a in (ro, rd, vd, z)),
                                                      compute_dtype=jnp.float32)
            ref, vjp = jax.vjp(jf, params)
            (jg,) = vjp(jnp.asarray(g))
            before = (fused_mlp.fused_rays_planes.launches, fused_mlp_wide.fused_rays_planes_wide.launches)
            out = fused_mlp.fused_query_rays_planes(mlp, cfg, pe_p, pe_v,
                                                    *(torch.from_numpy(a) for a in (ro, rd, vd, z)),
                                                    compute_dtype=torch.float32)
            out.backward(torch.from_numpy(g))
            assert before == (fused_mlp.fused_rays_planes.launches,
                              fused_mlp_wide.fused_rays_planes_wide.launches)  # CPU: plain
            ins = []
        else:  # K2 / K3 with input grads
            pts = (ro[:, None] + rd[:, None] * z[..., None]).astype(np.float32)
            gr = np.ascontiguousarray(g.transpose(1, 2, 0))  # [R, S, 4]

            def jf(p, pt, v):
                return jfused.fused_query(p, jcfg, jpp, jpv, pt, v, compute_dtype=jnp.float32)
            ref, vjp = jax.vjp(jf, params, jnp.asarray(pts), jnp.asarray(vd))
            jg, jdx, jdv = vjp(jnp.asarray(gr))
            ins = [torch.from_numpy(pts).requires_grad_(True),
                   torch.from_numpy(vd).requires_grad_(True)]
            out = fused_mlp.fused_query(mlp, cfg, pe_p, pe_v, *ins, compute_dtype=torch.float32)
            out.backward(torch.from_numpy(gr))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=F32_TOL)
        grads = jax_params_from_state_dict({n: p.grad for n, p in mlp.named_parameters()}, cfg)
        pairs = [(str(k), np.asarray(a), np.asarray(b)) for (k, a), b in
                 zip(jax.tree_util.tree_leaves_with_path(grads), jax.tree.leaves(jg))]
        pairs += [(n, t.grad.numpy(), np.asarray(r)) for n, t, r in zip(("dx", "dv"), ins, (jdx, jdv))] \
            if ins else []
        for name, a, b in pairs:
            assert a.shape == b.shape, name
            err = float(np.abs(a - b).max() / np.abs(b).max())
            assert err <= WIDE_GRAD_TOL, (S, name, err)


# ROADMAP C.8: the backward sliced over points under a workspace budget


@pytest.fixture
def one_torch_thread():
    """Tiny ops: on torch's default thread pool beside other busy test
    processes they wait on the pool far longer than they compute (as
    tests/test_torch_port_cli.py's fixture says)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _meta_kp(W_, fp, fv, dtype=torch.bfloat16, scenes=()):
    """The packed leaves the slice planner reads (W1, and W05e and Wve for
    the octaves), of a configuration's shapes on the meta device."""
    def leaf(*shape):
        return torch.empty(*scenes, *shape, dtype=dtype, device="meta")

    return {"W1": leaf(W_, W_), "W05e": leaf(3 + 6 * fp, 2 * W_), "Wve": leaf(3 + 6 * fv, W_ // 2)}


@pytest.mark.parametrize("n,item,align,budget", [
    (4096, 10, 256, 1 << 20), (1000, 7, 1, 700), (1000, 7, 64, 700), (300, 5, 256, 100),
    (257, 3, 1, 3 * 257), (0, 9, 256, 1), (5, 1 << 20, 4, 1 << 21)])
def test_bwd_slices_cover_every_item_once_under_the_budget(monkeypatch, n, item, align, budget):
    """The slice planner: consecutive ranges that cover [0, n) once, cut at
    multiples of ``align``, each within the budget where one aligned unit
    fits in it, as even as alignment allows; one range where all fits."""
    monkeypatch.setattr(fused_mlp, "WORKSPACE_BUDGET", budget)
    slices = fused_mlp.bwd_slices(n, item, align)
    assert slices[0][0] == 0 and slices[-1][1] == n
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(slices, slices[1:]))
    assert all(a % align == 0 for a, _ in slices) and all(b > a for a, b in slices[:-1] or [])
    if n * item <= budget:
        assert slices == [(0, n)]
    elif align * item <= budget:
        assert all((b - a) * item <= budget for a, b in slices)
        sizes = [b - a for a, b in slices[:-1]]
        assert len(set(sizes)) <= 1 and len(slices) == -(-n // (budget // item // align * align))
    else:
        assert all(b - a <= align for a, b in slices)


def test_bwd_budget_slices_only_the_shapes_that_do_not_fit():
    """At the module's budget every path chip_smoke.py drives is one launch
    (the largest, 8 stacked scenes of 1024 rays at W = 512), and mip-NeRF
    360's NeRF shape (W = 1024, 2^14 rays, 192 fine samples), whose
    workspace would be ~123 GB, is cut into whole 256-ray slices; the
    per-point bytes are at least the workspace rows' (9.9 KB at W = 256,
    19.7 at 512, 39.1 at 1024, ROADMAP C.8)."""
    def n_slices(kp, rays, S, scenes=1):
        item = scenes * S * fused_mlp.bwd_point_bytes(kp, S)
        return fused_mlp.bwd_slices(rays, item, fused_mlp.SLICE_COLS)

    for W_, kb in ((256, 9.9), (512, 19.7), (1024, 39.1)):
        assert fused_mlp.bwd_point_bytes(_meta_kp(W_, 10, 4), 192) / 1000 >= kb
    assert n_slices(_meta_kp(256, 10, 4), 4096, 192) == [(0, 4096)]
    assert n_slices(_meta_kp(256, 16, 6), 4096, 192) == [(0, 4096)]
    assert n_slices(_meta_kp(512, 10, 4), 4096, 192) == [(0, 4096)]
    assert n_slices(_meta_kp(512, 10, 4, scenes=(8,)), 1024, 192, 8) == [(0, 1024)]
    assert n_slices(_meta_kp(256, 10, 4, scenes=(8,)), 1024, 192, 8) == [(0, 1024)]
    mip = n_slices(_meta_kp(1024, 10, 4), 16384, 192)
    assert mip == [(a, a + 4096) for a in range(0, 16384, 4096)]


def _leaf_grads(run, leaves, ins=()):
    """Grads of the packed leaves (and of ``ins``) after ``run()``'s
    backward, detached."""
    for t in (*leaves, *ins):
        t.grad = None
    run()
    return [t.grad.clone() for t in (*leaves, *ins)]


def _sliced_cases(kp, kp_s, R, S):
    """(name, run, inputs that take a grad) for each autograd Function whose
    backward slices: K4, K3 (with input grads), the stacked K4 and K3, K6
    and the stacked K6, all on CPU tensors (their plain versions)."""
    rng = np.random.default_rng(5)
    ro, rd, vd, z = (torch.from_numpy(a) for a in _rays(7, R, S))
    x = fused_mlp._ray_points(ro, rd, z).requires_grad_(True)
    v = vd.clone().requires_grad_(True)
    sto, std, stv, stz = (torch.stack([t, t.flip(0)]) for t in (ro, rd, vd, z))
    noise = torch.from_numpy(rng.standard_normal((R, S)).astype(np.float32))
    cot = lambda *shape: torch.from_numpy((0.5 + rng.random(shape)).astype(np.float32) * 1e-2)  # noqa: E731
    g4, gp = cot(4, R, S), cot(R * S, 4)
    gs4, gsp = cot(4, 2, R, S), cot(2, R * S, 4)
    gm = [cot(R, 3), cot(R), cot(R), cot(R, S)]
    gms = [cot(2, R, 3), cot(2, R), cot(2, R), cot(2, R, S)]
    lv = [kp[n] for n in fused_mlp.KP_NAMES]
    ls = [kp_s[n] for n in fused_mlp.KP_NAMES]

    def bwd(outs, gs):
        torch.autograd.backward(outs, gs)

    return [
        ("K4", lambda: bwd(fused_mlp._FusedRaysPlanes.apply(ro, rd, vd, z, *lv), g4), ()),
        ("K3", lambda: bwd(fused_mlp._FusedPoints.apply(x, v, S, True, *lv), gp), (x, v)),
        ("K4s", lambda: bwd(fused_mlp._FusedRaysPlanesStacked.apply(sto, std, stv, stz, *ls),
                            gs4), ()),
        ("K3s", lambda: bwd(fused_mlp._FusedPointsStacked.apply(
            fused_mlp._ray_points(sto.flatten(0, 1), std.flatten(0, 1), stz.flatten(0, 1))
            .reshape(2, R * S, 3), stv, S, *ls), gsp), ()),
        ("K6", lambda: bwd(tfr._FusedRender.apply(ro, rd, vd, z, noise, True, *lv), gm), ()),
        ("K6s", lambda: bwd(tfr._FusedRenderStacked.apply(
            sto, std, stv, stz, torch.stack([noise, noise]), False, *ls), gms), ()),
    ]


def test_sliced_backward_matches_unsliced(nets, monkeypatch, one_torch_thread):
    """Each autograd Function's backward, cut by a budget monkeypatched
    small into 3 slices of 16 rays (views) on the CPU's plain versions,
    gives the one launch's grads: the leaves' f32 sums within rtol 1e-5
    (relative L2; ROADMAP's f32 grad bound: the slices sum in another
    order), K3's dx and dv per point within the same."""
    _, mlp = nets
    R, S = 48, 8
    with torch.no_grad():
        base = fused_mlp.pack_params(mlp, PE_P, PE_V, torch.float32)
    kp = {k: t.detach().clone().requires_grad_(True) for k, t in base.items()}
    kp_s = {k: torch.stack([t, t * 0.9]).detach().requires_grad_(True) for k, t in base.items()}
    for name, run, ins in _sliced_cases(kp, kp_s, R, S):
        leaves = [(kp_s if name.endswith("s") else kp)[n] for n in fused_mlp.KP_NAMES]
        monkeypatch.setattr(fused_mlp, "WORKSPACE_BUDGET", fused_mlp.WORKSPACE_BUDGET)
        one = _leaf_grads(run, leaves, ins)
        scenes = 2 if name.endswith("s") else 1
        monkeypatch.setattr(fused_mlp, "SLICE_COLS", 16)
        monkeypatch.setattr(fused_mlp, "WORKSPACE_BUDGET",
                            16 * scenes * S * fused_mlp.bwd_point_bytes(kp, S))
        assert len(fused_mlp.bwd_slices(R, scenes * S * fused_mlp.bwd_point_bytes(kp, S),
                                        fused_mlp.SLICE_COLS)) == 3
        sliced = _leaf_grads(run, leaves, ins)
        monkeypatch.undo()
        for label, a, b in zip([*fused_mlp.KP_NAMES, "dx", "dv"], sliced, one):
            err = float((a - b).norm() / b.norm())
            assert a.shape == b.shape and err <= 1e-5, (name, label, err)


def test_sliced_wide_backward_matches_unsliced(monkeypatch, one_torch_thread):
    """K4w's launch plan on fused_mlp_wide.PlainOps under _FusedRaysPlanes'
    slicing (3 slices of 16 rays, each padded to its own 256-column tiles)
    against the one plan's grads, f32 within rtol 1e-5 a leaf."""
    _, mlp, _, (cfg, pe_p, pe_v) = _wide_nets(*WIDE["W128-16-6"])
    with torch.no_grad():
        base = fused_mlp.pack_params(mlp, pe_p, pe_v, torch.float32)
    kp = {k: t.detach().clone().requires_grad_(True) for k, t in base.items()}
    leaves = [kp[n] for n in fused_mlp.KP_NAMES]
    R, S = 48, 8
    ro, rd, vd, z = (torch.from_numpy(a) for a in _rays(3, R, S))
    g = (0.5 + torch.rand(4, R, S, generator=torch.Generator().manual_seed(2))) * 1e-2
    calls = []

    def plain_ops_bwd(kp_, *args):
        calls.append(args[3].shape[0])
        return fused_mlp_wide.rays_planes_bwd(fused_mlp_wide.PlainOps(), kp_, *args)

    monkeypatch.setattr(fused_mlp, "fused_rays_planes_bwd", plain_ops_bwd)
    run = lambda: fused_mlp._FusedRaysPlanes.apply(ro, rd, vd, z, *leaves).backward(g)  # noqa: E731
    one = _leaf_grads(run, leaves)
    monkeypatch.setattr(fused_mlp, "SLICE_COLS", 16)
    monkeypatch.setattr(fused_mlp, "WORKSPACE_BUDGET", 16 * S * fused_mlp.bwd_point_bytes(kp, S))
    sliced = _leaf_grads(run, leaves)
    assert calls == [R, 16, 16, 16]
    for name, a, b in zip(fused_mlp.KP_NAMES, sliced, one):
        err = float((a - b).norm() / b.norm())
        assert a.shape == b.shape and err <= 1e-5, (name, err)


# A model of the bf16 recompute's stores (csrc/fused_mlp_bwd.cu:
# RecomputeHook.store_rows_sw at csrc/fwd_tile_sm90.cuh's hook points), one
# agent a consumer warp: each warpgroup's 4 warps embed (warps 0-1 a point
# each thread, 2-3 a view; staging rows in act's first blocks, then emb /
# embv rows), meet at the warpgroup's named barrier, and run each layer:
# products issued (wgmma reads all of act, or emb), the hook on the
# previous output (warp w reads its 16-point quarter of the buffer and
# writes those points' workspace rows and mask words), the barrier that
# retires the products (finish_layer), the epilogue (warp w writes its own
# 16 rows of act). hv's epilogue and hook sit between two barriers. Any
# interleaving of the 8 warps must read each buffer as the output it
# stores, rewrite no buffer before its readers are done, and write every
# row and mask word of every tile once. Barrier phases as the card's
# bar.sync: a warp goes on once all 4 of its warpgroup have arrived.
TILE, HALF, QUARTER = 128, 64, 16


class _NamedBarrier:
    def __init__(self, count):
        self.count, self.arrived, self.phase = count, 0, 0

    def arrive(self):
        """The phase to wait for (bar.sync: arrive, then wait)."""
        self.arrived += 1
        if self.arrived == self.count:
            self.arrived, self.phase = 0, self.phase + 1
            return self.phase - 1
        return self.phase


def _cta_tiles(walk, ntiles, sms, scenes):
    """Each CTA's tiles in its walk's order: TileWalk over a grid of
    min(tiles, sms); SceneWalk over scene_grid's (fwd_tile_sm90.cuh)."""
    if walk == "tile":
        return [list(range(x, ntiles, sms)) for x in range(min(ntiles, sms))]
    tps = ntiles // scenes
    gx = min(tps, max(1, sms // scenes))
    return [list(range(y * tps + x, (y + 1) * tps, gx)) for y in range(scenes) for x in range(gx)]


def _recompute_stores(W, dense, tiles, n_pad, rng, out):
    """Runs one CTA's 8 consumer warps over ``tiles`` in a random
    interleaving, adding each write of a workspace row / mask word element
    to ``out`` (rows and masks: (count, warp, layer in flight) arrays);
    raises AssertionError on a hazard or a deadlock."""
    blocks = fused_mlp.ws_rows(W)[0]
    nb = W // 64
    ke, kv = fused_mlp.KE, fused_mlp.KV
    spt, svw = 2 * (ke + 2), 2 * (kv + 2)  # staging row bytes (FWD_SPT, FWD_SVW)
    lines = lambda lo, n: {(lo + k) // 128 for k in range(n)}  # noqa: E731 (128-byte lines)
    cells = {}  # (wg, buffer, block, row) -> (what, readers still to read it)
    bars = [_NamedBarrier(4) for _ in range(2)]
    done = {}  # (wg, layer, tile) -> warps whose products retired

    def write(wg, buf, blk, rows, what, warp):
        for r in rows:
            old = cells.get((wg, buf, blk, r))
            assert old is None or not old[1], \
                f"warp {warp} of {wg} rewrote {buf} {blk}/{r} before {sorted(old[1])} read {old[0]}"
            cells[(wg, buf, blk, r)] = (what, set())

    def expect(wg, buf, blk, rows, readers):
        for r in rows:
            cells[(wg, buf, blk, r)][1].update(readers)

    def read(wg, buf, blk, rows, what, warp):
        for r in rows:
            got, left = cells.get((wg, buf, blk, r), (None, set()))
            assert got == what, f"warp {warp} of {wg} read {buf} {blk}/{r}: {got}, not {what}"
            left.discard(warp)

    def hook(wg, warp, buf, blk0, ncols, what, row0, mrow, p0, layer):
        """store_rows_sw on warp's quarter: read, then the rows and words."""
        q = range(QUARTER * warp, QUARTER * (warp + 1))
        for blk in range(blk0, blk0 + -(-ncols // 64)):
            read(wg, buf, blk, q, what, warp)
        p = p0 + QUARTER * warp
        for arr, lo, n in ((out[0], row0, ncols), (out[1], mrow, ncols // 32)):
            if lo is not None:
                arr[0][lo:lo + n, p:p + QUARTER] += 1
                arr[1][lo:lo + n, p:p + QUARTER] = warp
                arr[2][lo:lo + n, p:p + QUARTER] = layer

    def bar_sync(wg):
        return ("bar", wg, bars[wg].arrive())

    def epilogue(wg, warp, blks, what, layer, tile):
        # finish_layer's barrier retired every warp's products of the layer
        assert done.get((wg, layer, tile), 0) == 4, f"epilogue {layer} before the products retired"
        for blk in blks:
            write(wg, "act", blk, range(QUARTER * warp, QUARTER * (warp + 1)), what, warp)
            expect(wg, "act", blk, range(QUARTER * warp, QUARTER * (warp + 1)), {warp})

    def warp_program(wg, warp):
        outs = [(f"h{i}", i * (W // 32)) for i in range(8)] + [("feat", None)]
        for tile in tiles:
            p0 = tile * TILE + wg * HALF
            # embed_sw: each thread its staging row, then its emb / embv row
            for t in range(32 * warp, 32 * warp + 32):
                i, pts = t % HALF, t < HALF
                lo = i * spt if pts else HALF * spt + i * svw
                for ln in lines(lo, spt if pts else svw):
                    write(wg, "act", ln // 64, [ln % 64], ("staging", tile), warp)
                buf = "emb" if pts else "embv"
                write(wg, buf, 0, [i], ("e", tile), warp)
                quarter = i // QUARTER
                expect(wg, buf, 0, [i], {quarter} if pts or dense else set())
            yield bar_sync(wg)
            for layer in range(10):  # products of layer; hook on the previous output
                yield None
                if layer == 0:
                    hook(wg, warp, "emb", 0, ke, ("e", tile), blocks["e"][0], None, p0, 0)
                    if dense:
                        hook(wg, warp, "embv", 0, kv, ("e", tile), blocks["ev"][0], None, p0, 0)
                else:
                    name, mrow = outs[layer - 1]
                    hook(wg, warp, "act", 0, W, (layer - 1, tile), blocks[name][0], mrow, p0,
                         layer)
                done[(wg, layer, tile)] = done.get((wg, layer, tile), 0) + 1
                yield bar_sync(wg)  # finish_layer
                if layer < 9:
                    epilogue(wg, warp, range(nb), (layer, tile), layer, tile)
                    yield bar_sync(wg)  # before the next layer's products
                else:  # hv to act's first W/2 columns, between two barriers
                    epilogue(wg, warp, range(W // 128), (9, tile), 9, tile)
                    yield bar_sync(wg)
                    hook(wg, warp, "act", 0, W // 2, (9, tile), blocks["hv"][0],
                         8 * (W // 32), p0, 10)
                    yield bar_sync(wg)

    agents = [warp_program(wg, w) for wg in range(2) for w in range(4)]
    waiting = [None] * len(agents)
    live = list(range(len(agents)))
    while live:
        ready = [i for i in live
                 if waiting[i] is None or bars[waiting[i][1]].phase > waiting[i][2]]
        assert ready, "deadlock: every warp waits"
        i = ready[rng.integers(len(ready))]
        try:
            waiting[i] = next(agents[i])
        except StopIteration:
            live.remove(i)


# (mode, points, points a view direction covers): a direction per point
# (the view embedding's rows too) and per ray; rays and points modes differ
# in nothing else the stores see
RECOMPUTE_MODEL_CASES = [("rays", 7 * 43, 43), ("rays", 300, 1), ("points", 301, 1),
                         ("points", 768, 3)]


@pytest.mark.parametrize("walk", ["tile", "scene"])
@pytest.mark.parametrize("case", RECOMPUTE_MODEL_CASES, ids=lambda c: f"{c[0]}-{c[1]}-spr{c[2]}")
@pytest.mark.parametrize("width", [128, 256])
def test_recompute_stores_write_each_row_once(width, case, walk):
    """The recompute's stores (the model above), in random interleavings of
    a CTA's 8 consumer warps over 2 SMs' persistent grid (several tiles a
    CTA) or 2 scenes' rows of it: no warp reads a buffer that holds another
    output than the one it stores, no buffer is rewritten before its
    readers have read it (the hook's quarter, the embedding's warps, the
    products before the epilogue), nothing deadlocks, and every (feature,
    point) of the workspace rows (e, h0..h7, feat, hv; ev with a direction
    per point) and every mask word of h0..h7 and hv, padded points
    included, is written once, by the warp of its point's quarter, while
    the next layer's products run (hv's after the view layer)."""
    mode, n, spr = case
    scenes = 2 if walk == "scene" else 1
    ntiles = scenes * -(-n // TILE)
    n_pad = ntiles * TILE
    blocks, rows_total = fused_mlp.ws_rows(width)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        out = [[np.zeros((k, n_pad), np.int64) for _ in range(3)]
               for k in (rows_total, fused_mlp.mask_rows(width))]
        for tiles in _cta_tiles(walk, ntiles, 2, scenes):
            _recompute_stores(width, spr == 1, tiles, n_pad, rng, out)
        (rows, rwarp, rlayer), (masks, mwarp, mlayer) = out
        want = np.zeros_like(rows)
        layer = np.zeros_like(rows)
        names = ["e"] + [f"h{j}" for j in range(8)] + ["feat", "hv", "ev"]
        for name, at in zip(names, [0, *range(1, 10), 10, 0]):
            r0, k = blocks[name]
            if name != "ev" or spr == 1:
                want[r0:r0 + k], layer[r0:r0 + k] = 1, at
        quarter = (np.arange(n_pad) % HALF) // QUARTER
        assert np.array_equal(rows, want)
        assert np.array_equal(rlayer[want > 0], layer[want > 0])
        assert np.array_equal(rwarp[want > 0], np.broadcast_to(quarter, want.shape)[want > 0])
        assert np.array_equal(masks, np.ones_like(masks))
        mask_layer = np.repeat(np.r_[np.arange(1, 9), 10], [width // 32] * 8 + [width // 64])
        assert np.array_equal(mlayer, np.broadcast_to(mask_layer[:, None], masks.shape))
        assert np.array_equal(mwarp, np.broadcast_to(quarter, masks.shape))


@pytest.mark.parametrize("spr", [1, 2])
def test_stacked_recompute_columns_are_each_scenes(spr):
    """``bwd_recompute_stacked``'s layout, which the card test holds the
    stacked launch to: scene s's padded points (``_pad_points``) in columns
    [s * P_pad, (s + 1) * P_pad) of every workspace row and mask word, each
    scene through its own net; on the CPU its plain version."""
    S, P = 2, 100
    kps = [fused_mlp.pack_params(NeRFMLP(CFG, seed=s, device="cpu"), PE_P, PE_V, torch.bfloat16)
           for s in range(S)]
    kp = {k: torch.stack([q[k] for q in kps]) for k in kps[0]}
    rng = np.random.default_rng(spr)
    x = torch.from_numpy(rng.uniform(-1, 1, (S, P, 3)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((S, P // spr, 3)).astype(np.float32))
    got = fused_mlp.bwd_recompute_stacked(kp, x, v, spr)
    P_pad = fused_mlp._pad_points(P, spr)
    assert P_pad % 128 == 0 and got.raw is None
    assert got.masks.shape == (fused_mlp.mask_rows(W), S * P_pad)
    for s in range(S):
        xp = torch.nn.functional.pad(x[s], (0, 0, 0, P_pad - P))
        vp = torch.nn.functional.pad(v[s], (0, 0, 0, (P_pad - P) // spr))
        one = fused_mlp.bwd_recompute(kps[s], xp, vp, spr)
        cols = slice(s * P_pad, (s + 1) * P_pad)
        assert sorted(got.rows) == sorted(k for k in one.rows if k != "ev" or spr == 1)
        for name, rows in got.rows.items():
            assert torch.equal(rows[:, cols], one.rows[name]), (s, name)
        assert torch.equal(got.masks[:, cols], one.masks), s
