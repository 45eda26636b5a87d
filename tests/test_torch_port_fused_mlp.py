"""The port's fused posenc+MLP forward (ops/fused_mlp.py) against nerf_tpu.

On the CPU the wrapper takes the kernel's plain PyTorch version; it is held
to nerf_tpu's Pallas kernel, run in interpret mode as tests/test_fused_mlp.py
runs it. The CUDA kernel itself is checked on the card by
tests/test_torch_port_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.embedding import PosEncConfig as JPosEnc
from nerf_tpu.models.nerf_mlp import MLPConfig as JMLPConfig
from nerf_tpu.models.nerf_mlp import init_params
from nerf_tpu.ops import fused_mlp as jfused
from nerf_tpu_torch.models.convert import state_dict_from_jax_params
from nerf_tpu_torch.models.embedding import PosEncConfig
from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
from nerf_tpu_torch.ops import fused_mlp

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
    # the workspace rows written once (4 of gc's 8), the f32 d_hv rows, g and z
    assert fused_mlp.bwd_tile_bytes_per_point(MLPConfig()) == 9_872 - 8 + 512 + 16 + 4


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
    # a multiple of 128 that the kernel is not built for, or too many octaves
    assert not fused_mlp.supports(MLPConfig(width=384), PE_P, PE_V)
    assert not fused_mlp.supports(CFG, PosEncConfig(11), PE_V)
    assert not fused_mlp.supports(CFG, PE_P, PosEncConfig(5))


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
