"""The evaluation part of ``s2anet_tpu/data/augment.py``, without cv2:
letterboxing and the polygon / box maps in and out of it.

``letterbox`` resizes with ``torch.nn.functional.interpolate`` (bilinear,
half-pixel centres, no antialiasing) on the CPU and rounds to uint8, where
the JAX package calls ``cv2.resize(INTER_LINEAR)``: cv2 interpolates uint8
with 11-bit fixed-point weights, so a resized pixel may differ from it by
one level. The constant border is written in NumPy and is exact, so an
image that needs no resize (square DOTA chips) letterboxes exactly as there.
Flips, rotations, HSV, mosaic and the affine warp wait for the training
slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``[H, W, C]`` uint8 -> ``[h, w, C]`` uint8 at ``size = (w, h)``
    (cv2's order), bilinear with half-pixel centres."""
    w, h = size
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    y = torch.nn.functional.interpolate(x, size=(h, w), mode="bilinear",
                                        align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def letterbox(
    img: np.ndarray,
    new_shape: Tuple[int, int],
    pad_value: int = 114,
    scaleup: bool = True,
) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """Aspect-preserving resize + centre pad.

    Returns (img, ratio, (left, top)): the left and top pads.
    """
    shape = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw = (new_shape[1] - new_unpad[0]) / 2
    dh = (new_shape[0] - new_unpad[1]) / 2
    if shape[::-1] != new_unpad:
        img = resize_bilinear(img, new_unpad)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.full((img.shape[0] + top + bottom, img.shape[1] + left + right)
                  + img.shape[2:], pad_value, np.uint8)
    out[top: top + img.shape[0], left: left + img.shape[1]] = img
    return out, r, (left, top)


def scale_polys(polys: np.ndarray, ratio: float, pad: Tuple[float, float]):
    polys = polys.copy()
    polys[:, 0::2] = polys[:, 0::2] * ratio + pad[0]
    polys[:, 1::2] = polys[:, 1::2] * ratio + pad[1]
    return polys


def unletterbox_rboxes(rboxes: np.ndarray, ratio: float,
                       pad: Tuple[float, float],
                       orig_shape: Optional[Tuple[int, int]] = None):
    """Map rotated boxes from letterboxed coords back to the original image:
    remove the padding, divide centres and sides by the resize ratio, and
    clip centres to the image when ``orig_shape`` is given."""
    out = np.asarray(rboxes, np.float64).reshape(-1, 5).copy()
    out[:, 0] = (out[:, 0] - pad[0]) / ratio
    out[:, 1] = (out[:, 1] - pad[1]) / ratio
    out[:, 2:4] /= ratio
    if orig_shape is not None:
        h, w = orig_shape
        out[:, 0] = out[:, 0].clip(0, w)
        out[:, 1] = out[:, 1].clip(0, h)
    return out
