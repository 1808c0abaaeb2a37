"""``s2anet_tpu/data/augment.py`` without cv2: letterboxing and the polygon
/ box maps in and out of it, the training flips, 90-degree rotations,
centre filter, mixup, 4-image mosaic and its centre crop (the JAX
functions, copied), the HSV jitter, and the scale / translate warp.

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
the cv2 version bit for bit (tests/test_torch_port_augment.py).

:func:`random_perspective_rotation` (scale and translate: an axis-aligned
affine) warps with :func:`warp_affine`, a NumPy model of cv2's
``warpAffine`` with ``INTER_LINEAR`` and a constant border: the inverse
map in float64 as cv2 forms it, then source coordinates, interpolation
weights and the bilinear blend in float32 with fused multiply-adds, as
cv2 5's float32 kernels compute them on x86-64 (rows in vector blocks of
16 pixels; the row's last ``W % 16`` pixels form their coordinates without
the fused multiply-add), rounded half to even. The tests hold it within one
grey level of cv2 (OpenCV 4's fixed-point kernel, 1/32-pixel coordinates
and 15-bit weights, is up to several levels from cv2 5's).
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


def _cubic_taps(n_out: int, n_in: int, scale: float):
    """Source indices ``[n_out, 4]`` (clamped to the edge) and float32
    weights of cv2's bicubic (A = -0.75) at half-pixel centres."""
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    x = f - s
    a, one = np.float32(-0.75), np.float32(1)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, one - c0 - c1 - c2], -1).astype(np.float32)


def resize_bicubic(img: np.ndarray, rate: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=rate, fy=rate, interpolation=cv2.INTER_CUBIC)``
    on ``[H, W, C]`` uint8: the output size ``round(W * rate)`` x ``round(H *
    rate)`` (half to even), the edge pixel repeated past the border, and the
    two passes summed in float32 and rounded once at the end, as the IPP
    build of cv2 on x86-64 computes it (the fixed-point path without IPP
    rounds elsewhere; both are within one level of this, and it is held
    within one level of cv2), 256 output rows a block."""
    h, w = img.shape[:2]
    out_w, out_h = int(round(w * rate)), int(round(h * rate))
    xi, xc = _cubic_taps(out_w, w, 1.0 / rate)
    yi, yc = _cubic_taps(out_h, h, 1.0 / rate)
    src = img.reshape(h, w, -1)
    out = np.empty((out_h, out_w, src.shape[2]), np.uint8)
    for r0 in range(0, out_h, 256):
        r1 = min(r0 + 256, out_h)
        need = np.unique(yi[r0:r1])
        hx = np.zeros((len(need), out_w, src.shape[2]), np.float32)
        part = src[need].astype(np.float32)
        for k in range(4):  # horizontal pass on the rows this block reads
            hx += part[:, xi[:, k]] * xc[:, k, None]
        pos = np.searchsorted(need, yi[r0:r1])
        v = np.zeros((r1 - r0, out_w, src.shape[2]), np.float32)
        for k in range(4):
            v += hx[pos[:, k]] * yc[r0:r1, k, None, None]
        out[r0:r1] = np.clip(np.rint(v), 0, 255)
    return out.reshape((out_h, out_w) + img.shape[2:])


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


_WARP_BLOCK = 16  # pixels per iteration of cv2's vector loop (8-bit, 3 channels)


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """``a*b + c`` rounded once to float32 (the float32 product is exact in
    float64), as a fused multiply-add."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def warp_affine(img: np.ndarray, m: np.ndarray, border: int = 114) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), borderValue=(border,) * 3)`` for
    uint8 ``[H, W, C]`` and an axis-aligned ``m`` (``m[0, 1] = m[1, 0] =
    0``): output pixel (x, y) samples the source at ``m^-1 (x, y)``,
    bilinearly, with the border value for every tap outside the image."""
    m = np.asarray(m, np.float64)
    if m[0, 1] != 0 or m[1, 0] != 0:
        raise ValueError("warp_affine models axis-aligned maps only (no rotation or shear)")
    h, w = img.shape[:2]
    f32 = np.float32
    # cv2's inverse: d = 1/det, then b = -A t, in float64; used in float32
    d = m[0, 0] * m[1, 1]
    d = 1.0 / d if d != 0 else 0.0
    a0, a4 = f32(m[1, 1] * d), f32(m[0, 0] * d)
    a2, a5 = f32(-(m[1, 1] * d) * m[0, 2]), f32(-(m[0, 0] * d) * m[1, 2])
    x = np.arange(w, dtype=f32)
    sx = _fma32(x, a0, a2)
    tail = w // _WARP_BLOCK * _WARP_BLOCK
    sx[tail:] = x[tail:] * a0 + a2
    sy = np.arange(h, dtype=f32) * a4 + a5
    ix, iy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - ix)[None, :, None], (sy - iy)[:, None, None]
    # one border pixel around the image: every tap outside lands on it
    src = np.full((h + 2, w + 2) + img.shape[2:], border, np.uint8)
    src[1:-1, 1:-1] = img
    ix = ix.astype(np.int64)
    iy = iy.astype(np.int64)
    cols = [np.clip(ix + k, -1, w) + 1 for k in (0, 1)]
    rows = [src[np.clip(iy + k, -1, h) + 1] for k in (0, 1)]
    top, bottom = ([r[:, c].astype(f32) for c in cols] for r in rows)
    t0 = _fma32(ax, top[1] - top[0], top[0])
    t1 = _fma32(ax, bottom[1] - bottom[0], bottom[0])
    out = _fma32(ay, t1 - t0, t0)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def random_perspective_rotation(
    img: np.ndarray,
    polys: np.ndarray,
    degrees: float = 0.0,
    translate: float = 0.0,
    scale: float = 0.0,
    rng: Optional[np.random.Generator] = None,
):
    """Affine warp of image and polygon corners (the JAX function, with
    :func:`warp_affine`): a random 90-degree rotation when ``degrees > 0``,
    then scale ``1 + U(-scale, scale)`` about the centre and a translation
    of ``U(-translate, translate)`` of the image's size, drawn in that
    order; boxes whose centre leaves the image are dropped by the caller
    (:func:`filter_polys_center_inside`)."""
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]
    if degrees > 0:
        img, polys = rot90_image_and_polys(img, polys, int(rng.integers(0, 4)))
        h, w = img.shape[:2]

    s = 1.0 + rng.uniform(-scale, scale) if scale > 0 else 1.0
    tx = rng.uniform(0.5 - translate, 0.5 + translate) * w - w / 2 if translate else 0.0
    ty = rng.uniform(0.5 - translate, 0.5 + translate) * h - h / 2 if translate else 0.0
    if s == 1.0 and tx == 0.0 and ty == 0.0:
        return img, polys
    m = np.array([[s, 0, tx + (1 - s) * w / 2],
                  [0, s, ty + (1 - s) * h / 2]], np.float64)
    img = warp_affine(img, m, 114)
    if len(polys):
        pts = polys.reshape(-1, 4, 2)
        pts = pts * s + np.array([m[0, 2], m[1, 2]])
        polys = pts.reshape(-1, 8)
    return img, polys


def mosaic4(samples, img_size: int, pad_value: int = 114,
            rng: Optional[np.random.Generator] = None):
    """4-image mosaic on a ``2*img_size`` square canvas around a random
    centre; ``samples`` are 4 ``(img BGR uint8, polys [N, 8] px, cls [N])``
    at any size. Returns ``(canvas, polys, cls)``, boxes whose centre falls
    outside the canvas dropped."""
    rng = rng or np.random.default_rng()
    s = img_size
    yc = int(rng.uniform(s * 0.5, s * 1.5))
    xc = int(rng.uniform(s * 0.5, s * 1.5))
    canvas = np.full((2 * s, 2 * s, 3), pad_value, np.uint8)
    out_polys, out_cls = [], []
    for i, (img, polys, cls) in enumerate(samples):
        h, w = img.shape[:2]
        if i == 0:   # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(yc + h, 2 * s)
            x1b, y1b = w - (x2a - x1a), 0
        else:         # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(yc + h, 2 * s)
            x1b, y1b = 0, 0
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a),
                                       x1b:x1b + (x2a - x1a)]
        if len(polys):
            p = polys.copy()
            p[:, 0::2] += x1a - x1b
            p[:, 1::2] += y1a - y1b
            out_polys.append(p)
            out_cls.append(cls)
    polys = np.concatenate(out_polys, 0) if out_polys else np.zeros((0, 8))
    cls = np.concatenate(out_cls, 0) if out_cls else np.zeros((0,), np.int32)
    keep = filter_polys_center_inside(polys, 2 * s, 2 * s)
    return canvas, polys[keep], cls[keep]


def mosaic_center_crop(canvas: np.ndarray, polys: np.ndarray, cls: np.ndarray,
                       img_size: int):
    """The centre ``img_size`` square of the mosaic canvas (object scale
    kept); boxes whose centre falls outside it are dropped."""
    s = img_size
    off = s // 2
    img = canvas[off:off + s, off:off + s]  # a view
    if len(polys):
        polys = polys.copy()
        polys[:, 0::2] -= off
        polys[:, 1::2] -= off
        keep = filter_polys_center_inside(polys, s, s)
        polys, cls = polys[keep], cls[keep]
    return img, polys, cls
