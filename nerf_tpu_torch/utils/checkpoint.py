"""Checkpoints in the reference's ``.tar`` layout, with discovery and resume.

Counterpart of nerf_tpu/utils/checkpoint.py and the ``.tar`` half of
nerf_tpu/models/torch_import.py. The reference saves every ``i_weights``
steps to ``basedir/expname/{step:06d}.tar`` (run_nerf.py:792-803) and on
start-up loads the newest one there, or ``--ft_path``, unless
``--no_reload`` (run_nerf.py:216-233). nerf_tpu writes orbax directories
and reads a ``.tar`` only through ``--ft_path``; the port, which has no
orbax, writes and reads the ``.tar`` itself, so its checkpoints load in the
reference, in nerf_tpu (``--ft_path``) and back in the port.

A ``.tar`` holds ``{global_step, network_fn_state_dict,
network_fine_state_dict (with a fine net), optimizer_state_dict}`` exactly
as nerf_tpu's ``export_torch_checkpoint`` writes it: each net's parameters
in registration order (``views_linears.0`` included, as zeros without
viewdirs, as the reference registers it), and Adam's ``step``,
``exp_avg`` and ``exp_avg_sq`` for every parameter, coarse first, in that
order. ``global_step`` is the train state's step and Adam's ``step`` its
update count, as nerf_tpu writes them (a reference run's own tars save
global_step one below the count; both packages keep that as they find it).

Resume restores the parameters, both moments, the count and the step, so
the learning-rate schedule carries on from the step. Unlike nerf_tpu
(ROADMAP C), ``no_reload`` is honoured when ``ft_path`` is set, as in the
reference (run_nerf.py:222).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from nerf_tpu_torch.device import DeviceLike, resolve_device
from nerf_tpu_torch.models.factory import init_nets
from nerf_tpu_torch.render.network import NeRFModel
from nerf_tpu_torch.train.step import ADAM_BETAS, ADAM_EPS, TrainState, init_train_state

_NET_KEYS = (("coarse", "network_fn_state_dict"), ("fine", "network_fine_state_dict"))


def ckpt_path(basedir: str, expname: str, step: int) -> str:
    return os.path.join(basedir, expname, f"{step:06d}.tar")


def checkpoint_dict(state: TrainState) -> Dict:
    """The train state as the reference's ``.tar`` payload (CPU tensors)."""
    steps = [int(st["step"]) for st in state.optimizer.state.values() if "step" in st]
    count = max(steps) if steps else 0
    out: Dict = {"global_step": int(state.step)}
    opt_state: Dict = {}
    for level, key in _NET_KEYS:
        if level not in state.nets:
            continue
        net = state.nets[level]
        sd = {}
        for name, p in net.named_parameters():
            unused = name.startswith("views_linears") and not net.cfg.use_viewdirs
            value = torch.zeros_like(p) if unused else p.detach()
            sd[name] = value.cpu().clone()
            st = state.optimizer.state.get(p, {})
            opt_state[len(opt_state)] = {
                "step": torch.tensor(float(count)),
                "exp_avg": st.get("exp_avg", torch.zeros_like(p)).detach().cpu().clone(),
                "exp_avg_sq": st.get("exp_avg_sq", torch.zeros_like(p)).detach().cpu().clone(),
            }
        out[key] = sd
    out["optimizer_state_dict"] = {
        "state": opt_state,
        "param_groups": [{
            "lr": 0.0,  # the reference sets lr every step
            "betas": ADAM_BETAS,
            "eps": ADAM_EPS,
            "weight_decay": 0,
            "amsgrad": False,
            "params": list(range(len(opt_state))),
        }],
    }
    return out


def save_checkpoint(basedir: str, expname: str, state: TrainState) -> str:
    """Write ``basedir/expname/{step:06d}.tar``; returns its path."""
    path = ckpt_path(basedir, expname, int(state.step))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(checkpoint_dict(state), path)
    return path


def load_checkpoint(path: str, model: NeRFModel, lrate: float,
                    device: DeviceLike = None) -> TrainState:
    """A train state on ``device`` from a reference-layout ``.tar`` (the
    port's, nerf_tpu's export or the reference's own). Optimizer entries
    are matched to parameters by position in the tar's own state-dict
    order, as nerf_tpu's loader does; a no-viewdirs tar without
    ``views_linears.0`` (nerf_tpu's export omits it) loads with zeros
    there. A parameter with no entry starts with no Adam state."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    nets = init_nets(model, seed=0, device=dev)
    entries = (ckpt.get("optimizer_state_dict") or {}).get("state", {})
    offset = 0
    moments = []
    for level, key in _NET_KEYS:
        if level not in nets:
            continue
        sd = ckpt.get(key)
        if sd is None:
            raise ValueError(f"{path} has no {key} but the model has a {level} network")
        net = nets[level]
        full = dict(sd)
        if not net.cfg.use_viewdirs:
            for name, p in net.views_linears.named_parameters(prefix="views_linears"):
                full.setdefault(name, torch.zeros_like(p, device="cpu"))
        net.load_state_dict(full, strict=True)
        params = dict(net.named_parameters())
        for pos, name in enumerate(sd.keys()):
            entry = entries.get(offset + pos)
            if entry is not None and "exp_avg" in entry:
                moments.append((params[name], entry))
        offset += len(sd)
    state = init_train_state(nets, lrate, start_step=int(ckpt["global_step"]))
    for p, entry in moments:
        state.optimizer.state[p] = {
            "step": torch.tensor(float(entry.get("step", 0)), dtype=torch.float32),
            "exp_avg": entry["exp_avg"].to(dev, torch.float32).clone(),
            "exp_avg_sq": entry["exp_avg_sq"].to(dev, torch.float32).clone(),
        }
    return state


def find_checkpoints(basedir: str, expname: str) -> List[str]:
    """The experiment's ``.tar`` files, oldest first (ref run_nerf.py:219-221)."""
    d = os.path.join(basedir, expname)
    if not os.path.isdir(d):
        return []
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".tar")]


def maybe_resume(basedir: str, expname: str, state: TrainState, model: NeRFModel,
                 lrate: float, no_reload: bool = False, ft_path: Optional[str] = None,
                 device: DeviceLike = None) -> TrainState:
    """The reference's resume policy (run_nerf.py:216-233): ``ft_path`` if
    set, else the experiment's newest ``.tar``; nothing with ``no_reload``.
    Returns the loaded state, or ``state`` when there is nothing to load."""
    if ft_path not in (None, "None"):
        ckpts = [ft_path]
    else:
        ckpts = find_checkpoints(basedir, expname)
    if not ckpts or no_reload:
        return state
    if not ckpts[-1].endswith(".tar"):
        raise ValueError(
            f"ft_path={ckpts[-1]!r} is not a .tar checkpoint: the port reads the reference's "
            ".tar layout only; nerf_tpu's orbax directories load in nerf_tpu, whose "
            "cli/export_torch.py writes them out as a .tar")
    return load_checkpoint(ckpts[-1], model, lrate, device)
