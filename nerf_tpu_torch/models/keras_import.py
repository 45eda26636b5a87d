"""Import weights exported from the original TF/Keras NeRF.

Counterpart of nerf_tpu/models/keras_import.py and of the reference's
``NeRF.load_weights_from_keras`` (run_nerf_helpers.py:121-148): the npy
list holds [W, b] pairs in the order trunk(0..D-1), feature, views[0], rgb,
alpha, with Keras's ``[in, out]`` weights, which is nerf_tpu's pytree
layout: ``models/convert.py::state_dict_from_jax_params`` carries it into
the port's ``NeRFMLP`` (``load_state_dict(..., strict=True)``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from nerf_tpu_torch.models.nerf_mlp import MLPConfig


def params_from_keras(weights: Sequence[np.ndarray], cfg: MLPConfig) -> Dict:
    """The Keras list as nerf_tpu's pytree (numpy leaves, ``w`` [in, out])."""
    if not cfg.use_viewdirs:
        # the reference's own restriction (run_nerf_helpers.py:123): the
        # Keras weights were exported from the viewdirs model only
        raise ValueError(
            "params_from_keras only supports use_viewdirs=True: the TF/Keras "
            "reference checkpoint layout has feature/alpha/views/rgb heads "
            "(ref run_nerf_helpers.py:121-148)"
        )

    def pair(i):
        return {
            "w": np.asarray(weights[2 * i], np.float32),
            "b": np.asarray(weights[2 * i + 1], np.float32).reshape(-1),
        }

    params: Dict = {"trunk": [pair(i) for i in range(cfg.depth)]}
    params["feature"] = pair(cfg.depth)
    params["views"] = pair(cfg.depth + 1)
    params["rgb"] = pair(cfg.depth + 2)
    params["alpha"] = pair(cfg.depth + 3)
    return params

