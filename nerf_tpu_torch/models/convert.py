"""Weight and train-state carry-over between ``nerf_tpu`` and the port.

``nerf_tpu`` keeps each layer as ``{"w": [in, out], "b": [out]}`` under
``trunk[i] / alpha / feature / views / rgb / output``; the port's
``NeRFMLP`` keeps nerf-pytorch's ``[out, in]`` weights under
``pts_linears.i / alpha_linear / feature_linear / views_linears.0 /
rgb_linear / output_linear`` (the mapping of
nerf_tpu/models/torch_import.py:49-78). Both directions are plain numpy
transposes; nothing is rounded.

A train state crosses as plain numpy: ``{"params", "mu", "nu"}`` pytrees
keyed by level (``{"coarse": ..., "fine": ...}``), the Adam ``count`` and
the ``step``. On nerf_tpu's side these are ``TrainState.params``, the
``ScaleByAdamState`` (mu, nu, count) of its optax chain and
``TrainState.step``; on the port's side the nets, each parameter's Adam
``exp_avg`` / ``exp_avg_sq`` / ``step`` and ``TrainState.step``. Both
optimizers count completed updates, so either package can continue the
other's run.

A stacked state of multi-scene training (nerf_tpu's ``stack_states``: every
leaf with a leading scene axis S) crosses the same way, scene by scene:
``stacked_train_state_from_jax_arrays`` gives the port's stacked state
(parallel/multi_scene.py) and ``jax_arrays_from_stacked_train_state`` takes
it back.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from nerf_tpu_torch.device import DeviceLike
from nerf_tpu_torch.models.factory import init_nets
from nerf_tpu_torch.models.nerf_mlp import MLPConfig
from nerf_tpu_torch.render.network import NeRFModel
from nerf_tpu_torch.train.step import TrainState, adam_step_count, init_train_state

_HEADS = (
    ("alpha", "alpha_linear"),
    ("feature", "feature_linear"),
    ("views", "views_linears.0"),
    ("rgb", "rgb_linear"),
)


def _pairs(cfg: MLPConfig):
    """(pytree path, state_dict prefix) for every layer of ``cfg``."""
    pairs = [(("trunk", i), f"pts_linears.{i}") for i in range(cfg.depth)]
    if cfg.use_viewdirs:
        pairs += [((name,), prefix) for name, prefix in _HEADS]
    else:
        pairs.append((("output",), "output_linear"))
    return pairs


def _leaf(params: Mapping, path):
    node = params
    for key in path:
        node = node[key]
    return node


def state_dict_from_jax_params(params_np: Mapping, cfg: MLPConfig) -> Dict[str, torch.Tensor]:
    """``nerf_tpu`` pytree (numpy leaves) -> the port's state_dict.

    Without viewdirs, ``views_linears.0`` (registered but unused, as in the
    reference) is filled with zeros so the result loads with strict=True.
    """
    sd: Dict[str, torch.Tensor] = {}
    for path, prefix in _pairs(cfg):
        p = _leaf(params_np, path)
        sd[f"{prefix}.weight"] = torch.from_numpy(np.array(np.asarray(p["w"]).T, np.float32))
        sd[f"{prefix}.bias"] = torch.from_numpy(np.array(p["b"], np.float32).reshape(-1))
    if not cfg.use_viewdirs:
        W = cfg.width
        sd["views_linears.0.weight"] = torch.zeros(W // 2, W + cfg.input_ch_views)
        sd["views_linears.0.bias"] = torch.zeros(W // 2)
    return sd


def jax_params_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: MLPConfig) -> Dict:
    """Inverse of :func:`state_dict_from_jax_params`: the port's state_dict ->
    ``nerf_tpu`` pytree with numpy leaves (weights ``[in, out]``)."""

    def leaf(prefix):
        w = sd[f"{prefix}.weight"].detach().cpu().numpy()
        b = sd[f"{prefix}.bias"].detach().cpu().numpy()
        return {"w": np.array(w.T, np.float32), "b": np.array(b, np.float32)}

    params: Dict = {"trunk": [None] * cfg.depth}
    for path, prefix in _pairs(cfg):
        if path[0] == "trunk":
            params["trunk"][path[1]] = leaf(prefix)
        else:
            params[path[0]] = leaf(prefix)
    return params


def train_state_from_jax_arrays(
    arrays: Mapping, model: NeRFModel, lrate: float, device: DeviceLike = None
) -> TrainState:
    """nerf_tpu's train state as numpy (``params``, ``mu``, ``nu`` by level,
    ``count``, ``step``) -> the port's TrainState on ``device``."""
    nets = init_nets(model, seed=0, device=device)
    for level, net in nets.items():
        cfg = model.mlp_config(level)
        net.load_state_dict(state_dict_from_jax_params(arrays["params"][level], cfg), strict=True)
    state = init_train_state(nets, lrate, start_step=int(arrays["step"]))
    for level, net in nets.items():
        cfg = model.mlp_config(level)
        mu = state_dict_from_jax_params(arrays["mu"][level], cfg)
        nu = state_dict_from_jax_params(arrays["nu"][level], cfg)
        for name, p in net.named_parameters():
            state.optimizer.state[p] = {
                "step": adam_step_count(state.optimizer, float(arrays["count"]), p),
                "exp_avg": mu[name].to(p.device),
                "exp_avg_sq": nu[name].to(p.device),
            }
    return state


def jax_arrays_from_train_state(state: TrainState, model: NeRFModel) -> Dict:
    """Inverse of :func:`train_state_from_jax_arrays`: numpy ``params``,
    ``mu``, ``nu`` by level, the Adam ``count`` and the ``step``. A parameter
    without Adam state (before the first update) gives zero moments."""
    out: Dict = {"params": {}, "mu": {}, "nu": {}, "count": 0, "step": int(state.step)}
    for level, net in state.nets.items():
        cfg = model.mlp_config(level)
        sd = net.state_dict()
        mu, nu = {}, {}
        for name, p in net.named_parameters():
            st = state.optimizer.state.get(p, {})
            mu[name] = st.get("exp_avg", torch.zeros_like(p))
            nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
            if "step" in st:
                out["count"] = int(st["step"])
        out["params"][level] = jax_params_from_state_dict(sd, cfg)
        out["mu"][level] = jax_params_from_state_dict(mu, cfg)
        out["nu"][level] = jax_params_from_state_dict(nu, cfg)
    return out


def _tree_map(fn, *trees):
    """fn over the leaves of nested dicts / lists (nerf_tpu's pytrees)."""
    t0 = trees[0]
    if isinstance(t0, Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [_tree_map(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


def stacked_train_state_from_jax_arrays(
    arrays: Mapping, model: NeRFModel, lrate: float, device: DeviceLike = None
) -> TrainState:
    """A stacked nerf_tpu train state as numpy (``params``, ``mu``, ``nu`` by
    level with a leading scene axis; ``count`` and ``step`` shared, as the
    vmapped step keeps them per scene and equal) -> the port's stacked
    TrainState on ``device``."""
    from nerf_tpu_torch.parallel.multi_scene import stack_states

    n = len(np.asarray(arrays["params"]["coarse"]["trunk"][0]["b"]))
    scalar = lambda x: np.asarray(x).reshape(-1)[0]  # noqa: E731
    states = []
    for s in range(n):
        one = {k: _tree_map(lambda x: np.asarray(x)[s], arrays[k]) for k in ("params", "mu", "nu")}
        one.update(count=scalar(arrays["count"]), step=scalar(arrays["step"]))
        states.append(train_state_from_jax_arrays(one, model, lrate, device))
    return stack_states(states)


def jax_arrays_from_stacked_train_state(state: TrainState, model: NeRFModel) -> Dict:
    """Inverse of :func:`stacked_train_state_from_jax_arrays`: numpy
    ``params``, ``mu``, ``nu`` with the leading scene axis, ``count`` and
    ``step``."""
    from nerf_tpu_torch.parallel.multi_scene import unstack_states

    n = next(iter(state.nets.values())).n_scenes
    per = [jax_arrays_from_train_state(st, model) for st in unstack_states(state, n)]
    out = {k: _tree_map(lambda *xs: np.stack(xs), *(p[k] for p in per))
           for k in ("params", "mu", "nu")}
    out.update(count=per[0]["count"], step=per[0]["step"])
    return out
