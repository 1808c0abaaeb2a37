"""``s2anet_tpu/data/augment.py`` without cv2: letterboxing and the polygon
/ box maps in and out of it, the training flips, 90-degree rotations,
centre filter and mixup (the JAX functions, copied), and the HSV jitter.

``letterbox`` resizes with ``torch.nn.functional.interpolate`` (bilinear,
half-pixel centres, no antialiasing) on the CPU and rounds to uint8, where
the JAX package calls ``cv2.resize(INTER_LINEAR)``: cv2 interpolates uint8
with 11-bit fixed-point weights, so a resized pixel may differ from it by
one level. The constant border is written in NumPy and is exact, so an
image that needs no resize (square DOTA chips) letterboxes exactly as there.

:func:`hsv_augment` is cv2's 8-bit ``BGR2HSV`` (hue in [0, 180), integer
arithmetic with cv2's 12-bit division tables), the three lookup tables of
the JAX function, and cv2's 8-bit ``HSV2BGR`` (float32 sector formula, as
cv2's x86-64 build computes it: see :func:`hsv_to_bgr`), in NumPy: equal to
the cv2 version bit for bit (tests/test_torch_port_augment.py). Mosaic and the affine warp
(translate, scale) need cv2's resize and warpAffine; they are not ported
(ROADMAP.md Queue 1) and :func:`not_ported` names them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_HSV_SHIFT = 12


def _div_table(num: int, den: float) -> np.ndarray:
    """cv2's ``saturate_cast<int>((num << 12) / (den * i))`` for i in
    0..255 (0 at i = 0), rounded half to even as ``cvRound``."""
    i = np.arange(256, dtype=np.float64)
    out = np.zeros(256, np.int64)
    out[1:] = np.rint((num << _HSV_SHIFT) / (den * i[1:]))
    return out


_SDIV = _div_table(255, 1.0)
_HDIV180 = _div_table(180, 6.0)


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HSV) for uint8 ``[H, W, 3]``."""
    bgr = img.astype(np.int64)
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


# per sector: which of (v, p, q, t) are b, g, r (cv2's sector_data)
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
# pixels per iteration of cv2's vector loop (4 x 8 float lanes, AVX2)
_HSV_BLOCK = 32


def _one_minus(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``1 - a*b`` rounded once to float32, as the fused multiply-add cv2's
    compiled code uses (the float32 product is exact in float64)."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2BGR) for uint8 ``[H, W, 3]`` (hue in
    [0, 180)). cv2 converts each row in vector blocks of 32 pixels, which
    truncate the final ``* 255``, and converts the row's last ``W % 32``
    pixels one at a time, which round it half to even; both form
    ``1 - s*h`` with one rounding."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    h = h - sector
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * _one_minus(s, h), v * _one_minus(s, one - h)])
    idx = np.moveaxis(_SECTOR[sector.astype(np.int64) % 6], -1, 0)
    bgr = np.moveaxis(np.take_along_axis(tab, idx, 0), 0, -1) * f32(255.0)
    vec = (hsv.shape[1] // _HSV_BLOCK) * _HSV_BLOCK
    out = np.rint(bgr)
    out[:, :vec] = np.trunc(bgr[:, :vec])
    return np.clip(out, 0, 255).astype(np.uint8)


def hsv_augment(img: np.ndarray, h_gain=0.5, s_gain=0.5, v_gain=0.5,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random HSV jitter through lookup tables (the JAX function, with the
    colour conversions above). img: BGR uint8; draws ``rng.uniform(-1, 1,
    3)`` once."""
    if not (h_gain or s_gain or v_gain):
        return img
    rng = rng or np.random.default_rng()
    r = rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1
    hsv = bgr_to_hsv(img)
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(img.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(img.dtype)
    hsv = np.stack([lut_hue[hsv[..., 0]], lut_sat[hsv[..., 1]], lut_val[hsv[..., 2]]], -1)
    return hsv_to_bgr(hsv)


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


def fliplr_polys(img_w: int, polys: np.ndarray) -> np.ndarray:
    polys = polys.copy()
    polys[:, 0::2] = img_w - polys[:, 0::2]
    return polys


def flipud_polys(img_h: int, polys: np.ndarray) -> np.ndarray:
    polys = polys.copy()
    polys[:, 1::2] = img_h - polys[:, 1::2]
    return polys


def rot90_image_and_polys(img: np.ndarray, polys: np.ndarray, k: int):
    """Rotate image and polygons by k*90 degrees counter-clockwise (exact;
    the image is a view)."""
    k = k % 4
    if k == 0:
        return img, polys
    h, w = img.shape[:2]
    img = np.rot90(img, k)
    xs = polys[:, 0::2].copy()
    ys = polys[:, 1::2].copy()
    for _ in range(k):
        # (x, y) -> (y, w-1-x) for a CCW rot90 of an array of shape (h, w)
        xs, ys = ys, (w - 1) - xs
        h, w = w, h
    out = polys.copy()
    out[:, 0::2] = xs
    out[:, 1::2] = ys
    return img, out


def filter_polys_center_inside(polys: np.ndarray, img_h: int, img_w: int):
    """Keep boxes whose centre remains inside the image."""
    cx = polys[:, 0::2].mean(axis=1)
    cy = polys[:, 1::2].mean(axis=1)
    return (cx >= 0) & (cx < img_w) & (cy >= 0) & (cy < img_h)


def mixup(img1, polys1, cls1, img2, polys2, cls2,
          rng: Optional[np.random.Generator] = None):
    """Beta(32, 32) image blend with the union of the labels."""
    rng = rng or np.random.default_rng()
    r = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * r
           + img2.astype(np.float32) * (1 - r)).astype(img1.dtype)
    polys = np.concatenate([polys1, polys2], 0)
    cls = np.concatenate([cls1, cls2], 0)
    return img, polys, cls


def not_ported(mosaic: float = 0.0, translate: float = 0.0, scale: float = 0.0) -> None:
    """Raise where a configuration asks for an augmentation that needs
    cv2's warps."""
    asked = [n for n, v in (("mosaic", mosaic), ("translate", translate), ("scale", scale)) if v]
    if asked:
        raise NotImplementedError(
            f"augmentation {', '.join(asked)} needs cv2's resize/warpAffine and is not "
            f"ported: ROADMAP.md Queue 1, 'mosaic and the affine warp'")
