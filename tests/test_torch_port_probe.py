"""K7's plain versions against tools/probe_overlap.py's Pallas bodies, on the CPU.

tools/probe_overlap.py benches on 786,432-point arrays when it is imported
and imports nerf_tpu's fused ops, so it is never imported here: its
function definitions (and, for the arrays' test, its module-level
assignments) are taken from its syntax tree and run in a namespace with
small TILE, W, SPR and RPT (DEPTH stays 8: the skip sits at layer 5). The
bodies run through ``pl.pallas_call(..., interpret=True)`` with ``build``'s
and ``bench_k``'s BlockSpecs on a grid of 3 tiles. The CUDA kernel is held
to the same plain versions on the card (tests/test_torch_port_kernels.py,
chip_smoke.py phase 18).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nerf_tpu_torch.tools import probe_overlap as P

SCRIPT = Path(__file__).resolve().parents[1] / "tools" / "probe_overlap.py"
TILE, W, SPR, TILES = 32, 128, 8, 3
NPTS = TILE * TILES
# JAX's bodies and the port's plain versions round the same operands to bf16
# and sum in f32, in other orders, with other sin/cos; where a sum or a
# sine lands on the other side of a bf16 rounding edge an output moves by
# one ulp. Bound: two bf16 ulps of the output's largest magnitude (an ulp
# of a value in [2^k, 2^(k+1)) is 2^(k-7)), the card's bound; it must stay
# below the output's input-dependent spread.
TOL_REL = 2.0 ** -6
# weights N(0, 2/W) (the script's 0.05 at W=256 is 0.8/sqrt(W)): at W=128 the
# script's scale would shrink a relu chain's spread to ~1e-5, too small to
# tell a wrong body from a right one
SCALE = float(np.sqrt(2.0 / W))


def _script_namespace(arrays: bool = False, npts: int = NPTS) -> dict:
    """The script's functions (and with ``arrays`` its module-level arrays)
    at this file's sizes, without running its benches or imports."""
    tree = ast.parse(SCRIPT.read_text())
    # FLOP: bench_k's default argument, the script's TF/s yardstick
    ns = {"jax": jax, "jnp": jnp, "np": np, "pl": pl, "pltpu": pltpu, "FLOP": 0}
    sizes = {"TILE": TILE, "NPTS": npts, "W": W, "DEPTH": P.DEPTH, "SPR": SPR}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            code = node
        elif arrays and isinstance(node, (ast.Assign, ast.For)):
            target = node.targets[0] if isinstance(node, ast.Assign) else None
            if isinstance(target, ast.Name) and target.id in sizes:
                ns[target.id] = sizes[target.id]
                continue
            code = node
        else:
            continue
        exec(compile(ast.Module(body=[code], type_ignores=[]), str(SCRIPT), "exec"), ns)
    ns.update(sizes, RPT=TILE // SPR)
    return ns


def _pallas(ns, kernel, args):
    """``bench_k``'s pallas_call (``build``'s BlockSpecs are its special
    case: only x has NPTS rows), interpreted, over NPTS // TILE tiles."""
    in_specs = []
    for a in args:
        if a.shape[0] == NPTS:
            in_specs.append(pl.BlockSpec((TILE, a.shape[1]), lambda i: (i, 0),
                                         memory_space=pltpu.VMEM))
        elif a.shape[0] == NPTS // SPR:
            in_specs.append(pl.BlockSpec((TILE // SPR, a.shape[1]), lambda i: (i, 0),
                                         memory_space=pltpu.VMEM))
        else:
            in_specs.append(pl.BlockSpec(memory_space=pltpu.VMEM))
    f = pl.pallas_call(
        kernel,
        grid=(NPTS // TILE,),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((TILE, W), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((NPTS, W), jnp.float32),
        interpret=True,
    )
    return np.asarray(jax.jit(f)(*args))


def _jax_args(ns, inp: P.ProbeInputs, body: str):
    """The script's arguments of ``body`` (its call sites :200-202, :275-280)."""
    j = lambda t: jnp.asarray(t.float().numpy()).astype(  # noqa: E731
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    Ws, bs = [j(w) for w in inp.Ws], [j(b) for b in inp.bs]
    wb = [t for pair in zip(Ws, bs) for t in pair]
    Sp = np.zeros((3, 30), np.float32)  # the script's selector (:119-124)
    for f in range(10):
        for d in range(3):
            Sp[d, f * 3 + d] = 2.0 ** f
    Sp, Sv = jnp.asarray(Sp), jnp.asarray(Sp[:, :12])
    x3, W0e, W5e = j(inp.x3), j(inp.W0e), j(inp.W5e)
    if body == "matmul_only":
        return ns["k_matmul_only"], [j(inp.x)] + Ws
    if body in ("bias_relu", "interleaved"):
        return ns[f"k_{body}"], [j(inp.x)] + wb
    if body == "full":
        return ns["k_full"], [x3, j(inp.v3), Sp, Sv, W0e, W5e, Ws[0], j(inp.Wvf), j(inp.Wve),
                              j(inp.Wout)] + wb
    kernel = {"embed_trunk": ns["k_embed_trunk"],
              "embed_trunk_il": ns["k_embed_trunk_interleaved"],
              "embed_notrig": ns["mk_embed_trunk"](ns["embed_notrig"]),
              "embed_poly": ns["mk_embed_trunk"](ns["embed_poly"])}[body]
    return kernel, [x3, Sp, W0e, W5e] + wb


@pytest.mark.parametrize("body", P.SCRIPT_BODIES)
def test_probe_body_matches_script(body):
    ns = _script_namespace()
    inp = P.make_inputs(npts=NPTS, width=W, spr=SPR, seed=3, scale=SCALE)
    want = _pallas(ns, *_jax_args(ns, inp, body))
    got = P.probe_reference(body, inp).numpy()
    assert got.shape == want.shape == (NPTS, W)
    live = want[:, :4] if body == "full" else want
    tol = TOL_REL * float(np.abs(live).max())
    assert float(np.abs(got - want).max()) <= tol
    if body == "full":
        assert not got[:, 4:].any()
    assert tol < float(np.abs(live - live.mean(0)).mean())  # the bound sees the inputs


def test_products_body_is_the_sum_of_the_chain_products():
    """``products`` (no counterpart in the script): bf16 of the sum of the 8
    products x W_i, against numpy in float64 from the same bf16 operands,
    to the bound above (the f32 sums differ in order)."""
    inp = P.make_inputs(npts=NPTS, width=W, spr=SPR, seed=4, scale=SCALE)
    got = P.probe_reference("products", inp).numpy()
    x = inp.x.float().numpy().astype(np.float64)
    want = sum(x @ w.float().numpy().astype(np.float64) for w in inp.Ws)
    tol = TOL_REL * float(np.abs(want).max())
    assert got.shape == (NPTS, W)
    assert float(np.abs(got - want).max()) <= tol
    assert tol < float(np.abs(want - want.mean(0)).mean())


def test_make_inputs_matches_script_arrays():
    """The script's own draws (scale 0.05), bit for bit."""
    ns = _script_namespace(arrays=True)
    inp = P.make_inputs(npts=NPTS, width=W, spr=SPR, seed=0)
    pairs = [(inp.x, ns["x_in"]), (inp.x3, ns["x3"]), (inp.v3, ns["v3"]), (inp.W0e, ns["W0e"]),
             (inp.W5e, ns["W5e"]), (inp.Wvf, ns["Wvf"]), (inp.Wve, ns["Wve"]),
             (inp.Wout, ns["Wout"])]
    pairs += list(zip(inp.Ws, ns["Ws"])) + list(zip(inp.bs, ns["bs"]))
    for ours, theirs in pairs:
        assert ours.dtype == (torch.bfloat16 if theirs.dtype == jnp.bfloat16 else torch.float32)
        np.testing.assert_array_equal(ours.float().numpy(), np.asarray(theirs, np.float32))


def test_probe_wrapper_and_bounds():
    inp = P.make_inputs(npts=2 * SPR, width=W, spr=SPR, seed=1)
    before = P.probe.launches
    for body in P.BODIES:  # on the CPU the wrapper is the plain version
        assert torch.equal(P.probe(body, inp), P.probe_reference(body, inp))
    assert P.probe.launches == before
    with pytest.raises(ValueError):
        P.probe("bogus", inp)
    with pytest.raises(ValueError):
        P.make_inputs(npts=SPR + 1, width=W, spr=SPR)
    # the trunk bodies at the script's size: 8.25e11 FLOP against 1.21 GB
    assert P.probe_flops("bias_relu") == 824_633_720_832
    assert P.probe_bytes("bias_relu") == 1_209_016_320
    ms, by = P.probe_bound_ms("bias_relu")
    assert by == "operations" and abs(ms - 0.8338) < 1e-3
    # full adds the feature, view and head products, and a view layer per ray
    extra = P.NPTS * 2 * (256 * 256 + 256 * 128 + 384 * 4) + 4096 * 2 * 27 * 128
    assert P.probe_flops("full") == P.probe_flops("embed_trunk") + extra
