"""Oriented Response Network ops: Active Rotating Filters and rotation-
invariant pooling.

Counterpart of ``s2anet_tpu/ops/orn.py``. The ARF expansion is a static
permutation of the weight (a gather), so it needs no kernel. Output layout:
``expanded[cout * nRot + r, cin * nOrient + o, ky, kx]`` -- rotation is the
fastest-varying output channel, which rotation-invariant pooling relies on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# 45-degree-step rotations of a 3x3 (and trivial 1x1) kernel grid as
# 1-indexed source taps: after rotating by `angle`, output tap j reads input
# tap table[angle][j] (the standard ORN permutation table).
_KERNEL_ROTATIONS = {
    1: {a: (1,) for a in range(0, 360, 45)},
    3: {
        0: (1, 2, 3, 4, 5, 6, 7, 8, 9),
        45: (2, 3, 6, 1, 5, 9, 4, 7, 8),
        90: (3, 6, 9, 2, 5, 8, 1, 4, 7),
        135: (6, 9, 8, 3, 5, 7, 2, 1, 4),
        180: (9, 8, 7, 6, 5, 4, 3, 2, 1),
        225: (8, 7, 4, 9, 5, 1, 6, 3, 2),
        270: (7, 4, 1, 8, 5, 2, 9, 6, 3),
        315: (4, 1, 2, 7, 5, 3, 8, 9, 6),
    },
}


@functools.lru_cache(maxsize=None)
def arf_indices(n_orientation: int = 8, n_rotation: int = 8,
                kernel_size: int = 3) -> np.ndarray:
    """Scatter indices ``[nEntry, nRotation]`` (0-based): entry ``l`` of the
    weight lands at flat (orientation, ky, kx) entry ``idx[l, k]`` of
    rotated copy ``k``."""
    if n_orientation & (n_orientation - 1) or n_rotation & (n_rotation - 1):
        raise ValueError("orientation and rotation counts must be powers of 2")
    kk = kernel_size * kernel_size
    delta_orient = 360 // n_orientation
    delta_rot = 360 // n_rotation
    idx = np.zeros((n_orientation * kk, n_rotation), dtype=np.int64)
    for o in range(n_orientation):
        for j in range(kk):
            for k in range(n_rotation):
                angle = (delta_rot * k) % 360
                layer = (o + angle // delta_orient) % n_orientation
                tap = _KERNEL_ROTATIONS[kernel_size][angle][j]
                idx[o * kk + j, k] = layer * kk + (tap - 1)
    return idx


@functools.lru_cache(maxsize=None)
def _arf_gather_indices(n_orientation: int, n_rotation: int,
                        kernel_size: int) -> np.ndarray:
    """Inverse permutation: ``gather[k, e]`` = source entry of entry ``e``."""
    scatter = arf_indices(n_orientation, n_rotation, kernel_size)
    gather = np.zeros((n_rotation, scatter.shape[0]), dtype=np.int64)
    for k in range(n_rotation):
        gather[k, scatter[:, k]] = np.arange(scatter.shape[0])
    return gather


def rotate_arf(weight: torch.Tensor, n_rotation: int = 8) -> torch.Tensor:
    """``[Cout, Cin, nOrient, k, k]`` -> ``[Cout*nRot, Cin*nOrient, k, k]``
    (OIHW), rotation fastest on the output-channel axis."""
    cout, cin, n_orient, kh, kw = weight.shape
    if kh != kw:
        raise ValueError("ARF kernels are square")
    gather = torch.from_numpy(_arf_gather_indices(n_orient, n_rotation, kh))
    flat = weight.reshape(cout, cin, n_orient * kh * kw)
    expanded = flat[:, :, gather.to(weight.device)]  # [Cout, Cin, nRot, nEntry]
    expanded = expanded.transpose(1, 2)              # [Cout, nRot, Cin, nEntry]
    return expanded.reshape(cout * n_rotation, cin * n_orient, kh, kw)


def rotation_invariant_pooling(x: torch.Tensor,
                               n_orientation: int = 8) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> ``[B, H, W, C // nOrient]``: the max over
    each feature's nOrient rotated responses (channel = feature*nOrient+rot)."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w, c // n_orientation, n_orientation).amax(-1)
