"""Configuration: typed dataclass + config-file/CLI layering.

The port's own copy of nerf_tpu/config.py, with the same fields, defaults
and parsing: every flag of the reference ``config_parser``
(run_nerf.py:421-531) with its name and default, the ``key = value``
config-file format (configs/*.txt), and CLI over file over defaults
(configargparse layering, run_nerf.py:425).

The additions beyond the reference sit at the bottom of the dataclass:
compute dtype, fused-kernel toggle, data-parallel controls and a seed (the
reference seeds numpy only, run_nerf.py:23). Fields that only nerf_tpu's
JAX runtime reads (``coordinator_address``, ``num_processes``,
``process_id``, ``donate_state``, ``fuse_steps``) are kept so a config
parses the same in both packages; the port ignores them.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    # --- reference flags (names + defaults match run_nerf.py:421-531) ---
    config: Optional[str] = None
    expname: str = "exp"
    basedir: str = "./logs/"
    datadir: str = "./data/llff/fern"

    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    N_rand: int = 32 * 32 * 4
    lrate: float = 5e-4
    lrate_decay: int = 250
    chunk: int = 1024 * 32
    netchunk: int = 1024 * 64
    no_batching: bool = False
    no_reload: bool = False
    ft_path: Optional[str] = None

    N_samples: int = 64
    N_importance: int = 0
    perturb: float = 1.0
    use_viewdirs: bool = False
    i_embed: int = 0
    multires: int = 10
    multires_views: int = 4
    raw_noise_std: float = 0.0

    render_only: bool = False
    render_test: bool = False
    render_factor: int = 0

    precrop_iters: int = 0
    precrop_frac: float = 0.5

    dataset_type: str = "llff"
    testskip: int = 8
    shape: str = "greek"

    white_bkgd: bool = False
    half_res: bool = False

    factor: int = 8
    no_ndc: bool = False
    lindisp: bool = False
    spherify: bool = False
    llffhold: int = 8

    i_print: int = 100
    i_img: int = 500
    i_weights: int = 10000
    i_testset: int = 50000
    i_video: int = 50000

    # --- extensions beyond the reference ---
    n_iters: int = 200000  # ref hardcodes 200k (run_nerf.py:701); configurable here
    seed: int = 0
    compute_dtype: str = "bfloat16"  # matmul dtype; "float32" for strict parity
    fused_kernels: bool = True  # the fused posenc+MLP kernels (K1 forward, K4 backward)
    fused_render: bool = False  # single-kernel rays->maps path (K5/K6, experimental/fused_render.py)
    data_axis: int = 0  # devices on the 'data' mesh axis; 0 = all, 1 = no mesh
    # nerf_tpu's multi-host process group (ignored by the port)
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    donate_state: bool = True  # nerf_tpu's jit buffer donation (ignored by the port)
    debug_nan: bool = False  # per-step non-finite loss scan (ref DEBUG, run_nerf.py:24)
    trace: bool = False  # capture a profiler trace of a few steady steps (expdir/trace)
    # nerf_tpu's multi-step lax.scan fusion (ignored by the port; the port's
    # counterpart is a CUDA graph, ROADMAP A.3)
    fuse_steps: int = 50
    # strict behavioral parity with the reference's i_img holdout pick
    # (np.random.choice over i_val, run_nerf.py:836-840 — dead code there,
    # live here): True draws the holdout view randomly (seeded from `seed`);
    # False (default) cycles val views deterministically
    i_img_random: bool = False

    @property
    def ndc(self) -> bool:
        # NDC only for llff without --no_ndc (run_nerf.py:250-253)
        return self.dataset_type == "llff" and not self.no_ndc


_BOOL_FLAGS = {
    f.name
    for f in dataclasses.fields(NeRFConfig)
    if f.type == "bool" or f.type is bool
}


def _coerce(name: str, value: str):
    field_types = {f.name: f.type for f in dataclasses.fields(NeRFConfig)}
    t = field_types.get(name)
    if t is None:
        raise KeyError(f"unknown config key: {name}")
    value = value.strip()
    if name in _BOOL_FLAGS:
        return value.lower() in ("true", "1", "yes")
    if value == "None":
        return None
    if t in ("int", "Optional[int]", int):
        return int(value)
    if t in ("float", float):
        return float(value)
    return value


def parse_config_file(path: str) -> dict:
    """Parse a reference-format config file (``key = value`` lines, # comments)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise ValueError(f"bad config line: {line!r}")
            key, val = (s.strip() for s in line.split("=", 1))
            out[key] = _coerce(key, val)
    return out


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="nerf_tpu_torch")
    for f in dataclasses.fields(NeRFConfig):
        flag = f"--{f.name}"
        if f.name in _BOOL_FLAGS:
            # store_true like the reference, but also allow explicit False to
            # override a True from a config file
            parser.add_argument(
                flag, nargs="?", const=True, default=None,
                type=lambda v: v.lower() in ("true", "1", "yes"),
            )
        else:
            parser.add_argument(flag, default=None, type=str)
    return parser


def load_config(argv=None) -> NeRFConfig:
    """Layered config: defaults <- config file <- CLI (ref run_nerf.py:425)."""
    parser = build_argparser()
    ns = parser.parse_args(argv)
    values: dict = {}
    if ns.config is not None:
        values.update(parse_config_file(ns.config))
        values["config"] = ns.config
    for f in dataclasses.fields(NeRFConfig):
        v = getattr(ns, f.name)
        if v is None or f.name == "config":
            continue
        values[f.name] = v if f.name in _BOOL_FLAGS else _coerce(f.name, str(v))
    return NeRFConfig(**values)


def dump_config(cfg: NeRFConfig) -> str:
    """Serialize the resolved config (args.txt snapshot, ref run_nerf.py:628-633)."""
    lines = [
        f"{f.name} = {getattr(cfg, f.name)}"
        for f in sorted(dataclasses.fields(NeRFConfig), key=lambda f: f.name)
    ]
    return "\n".join(lines) + "\n"
