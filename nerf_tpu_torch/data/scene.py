"""The common Scene structure the dataset loaders emit (host-side numpy).

The four loaders each build one from a scene on disk: ``data/blender.py``,
``data/llff.py``, ``data/deepvoxels.py`` and ``data/linemod.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Scene:
    """images [N, H, W, 3] in [0,1]; poses [N, 3, 4]; render_poses [M, 3|4, 4];
    hwf (H, W, focal); K [3, 3]; split index arrays; scene bounds."""

    images: np.ndarray
    poses: np.ndarray
    render_poses: np.ndarray
    hwf: tuple
    K: np.ndarray
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: np.ndarray
    near: float
    far: float
    bds: Optional[np.ndarray] = None  # llff per-image depth bounds

    @property
    def H(self) -> int:
        return int(self.hwf[0])

    @property
    def W(self) -> int:
        return int(self.hwf[1])

    @property
    def focal(self) -> float:
        return float(self.hwf[2])


def default_intrinsics(H: int, W: int, focal: float) -> np.ndarray:
    return np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float32
    )
