"""Rotated anchor grids (NumPy), a copy of ``s2anet_tpu/models/anchors.py``,
and the head's grid of the default anchor made on a device by torch
operations (:func:`grid_anchors_on`), equal to the NumPy one.

Base size = the level's stride; one anchor per cell by default (scale 4,
ratio 1, angle 0); centres at ``0.5 * (stride - 1)`` past each cell origin.
Rows are in (h, w) row-major order, the order the head flattens its NHWC
outputs in. ``row0`` (not in the JAX copy) starts the grid at a later row.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch


def base_anchors(base_size: float, scales=(4.0,), ratios=(1.0,),
                 angles=(0.0,)) -> np.ndarray:
    """``[num_base, 3]`` of (w, h, angle)."""
    out = []
    for r, s, a in itertools.product(ratios, scales, angles):
        wr = math.sqrt(r)
        out.append((base_size * wr * s, base_size / wr * s, a))
    return np.array(out, dtype=np.float32).reshape(-1, 3)


def grid_anchors(featmap_size, stride, scales=(4.0,), ratios=(1.0,),
                 angles=(0.0,), row0: int = 0) -> np.ndarray:
    """``[H*W*A, 5]`` float32 anchors (x, y, w, h, theta) in image pixels.
    ``row0``: the map's rows are rows ``row0 ..`` of a taller map (one
    rank's rows of a height-sharded image), the same values as those rows
    of the taller grid."""
    h, w = featmap_size
    base = base_anchors(float(stride), tuple(scales), tuple(ratios),
                        tuple(angles))
    xs = np.arange(w, dtype=np.float32) * stride + 0.5 * (stride - 1)
    ys = np.arange(row0, row0 + h, dtype=np.float32) * stride + 0.5 * (stride - 1)
    ctr = np.stack([np.tile(xs, h), np.repeat(ys, w)], axis=1)  # [H*W, 2]
    na = base.shape[0]
    anchors = np.concatenate(
        [np.repeat(ctr[:, None, :], na, axis=1),
         np.broadcast_to(base[None], (h * w, na, 3))],
        axis=-1,
    )
    return anchors.reshape(-1, 5)


def grid_anchors_on(device, featmap_size, stride, row0: int = 0) -> torch.Tensor:
    """:func:`grid_anchors` of the default anchor (scale 4, ratio 1, angle
    0), the same float32 values, made on ``device`` by torch operations:
    nothing is copied from the host. Every value is a float32 sum or
    product of small integers and halves, exact in both."""
    h, w = featmap_size
    (bw, bh, ba), = base_anchors(float(stride)).tolist()
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride + 0.5 * (stride - 1)
    ys = (torch.arange(row0, row0 + h, dtype=torch.float32, device=device) * stride
          + 0.5 * (stride - 1))
    ctr = torch.stack([xs.repeat(h), ys.repeat_interleave(w)], 1)
    return torch.cat([ctr, *(torch.full((h * w, 1), v, dtype=torch.float32, device=device)
                             for v in (bw, bh, ba))], 1)
