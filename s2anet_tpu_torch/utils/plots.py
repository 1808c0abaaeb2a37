"""Drawing detections without cv2: the port of ``color`` and ``draw_rboxes``
(``s2anet_tpu/utils/plots.py``) in NumPy.

Each rotated box is drawn as its closed polygon (the corners of
:func:`..ops.polyiou.rbox_vertices_np` cast to int32, as the JAX function
hands them to ``cv2.polylines``): a pixel takes the class's colour where
its centre lies within ``(thickness + 1) / 2`` of an edge, the
round-capped stroke cv2 draws (3 pixels wide at thickness 2). Within the
image every pixel either colours lies within one pixel of one the other
colours; on the image's border row or column, where an edge runs past the
image, cv2's clipped fill reaches up to about 1.9 pixels from the edge. The label (class name, score to two places) is written
where the JAX function puts it, ``(min x, max(min y - 3, 10))`` as the
text's bottom-left, in a built-in 5 x 7 bitmap font, where cv2 draws
Hershey glyphs: the pixels of the text are not cv2's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..ops.polyiou import rbox_vertices_np

# the JAX package's (Ultralytics-style) palette
_PALETTE = [
    (255, 56, 56), (255, 157, 151), (255, 112, 31), (255, 178, 29),
    (207, 210, 49), (72, 249, 10), (146, 204, 23), (61, 219, 134),
    (26, 147, 52), (0, 212, 187), (44, 153, 168), (0, 194, 255),
    (52, 69, 147), (100, 115, 255), (0, 24, 236), (132, 56, 255),
]

# 5 x 7 glyphs, one 5-bit row a hex byte, top row first (upper case is
# drawn as lower case; other characters as blanks)
_FONT = {
    "0": "0e11131519110e", "1": "040c040404040e", "2": "0e11010204081f",
    "3": "1f02040201110e", "4": "02060a121f0202", "5": "1f101e0101110e",
    "6": "0608101e11110e", "7": "1f010204080808", "8": "0e11110e11110e",
    "9": "0e11110f01020c", "a": "00000e010f110f", "b": "1010161911111e",
    "c": "00000e1010110e", "d": "01010d1311110f", "e": "00000e111f100e",
    "f": "0609081c080808", "g": "000f11110f010e", "h": "10101619111111",
    "i": "04000c0404040e", "j": "0200060202120c",
    "k": "10101214181412", "l": "0c04040404040e", "m": "00001a15151111",
    "n": "00001619111111", "o": "00000e1111110e", "p": "00001e111e1010",
    "q": "00000d130f0101", "r": "00001619101010", "s": "00000e100e011e",
    "t": "08081c08080906", "u": "0000111111130d", "v": "00001111110a04",
    "w": "0000111115150a", "x": "0000110a040a11",
    "y": "000011110f010e", "z": "00001f0204081f",
    "-": "0000001f000000", ".": "00000000000c0c", "_": "0000000000001f",
    ":": "000c0c000c0c00", " ": "00000000000000",
}
GLYPH_H, ADVANCE = 7, 6  # 5 x 7 glyphs a column apart


def color(i: int):
    return _PALETTE[i % len(_PALETTE)]


def _glyph(ch: str) -> np.ndarray:
    rows = bytes.fromhex(_FONT.get(ch.lower(), _FONT[" "]))
    return (np.array(list(rows), np.uint8)[:, None] >> np.arange(4, -1, -1)) & 1


def text_box(text: str, org):
    """``(x0, y0, x1, y1)``, the pixels (end exclusive) that
    :func:`put_text` may colour for ``text`` at ``org``."""
    x, y = org
    return x, y - GLYPH_H + 1, x + ADVANCE * len(text), y + 1


def put_text(img: np.ndarray, text: str, org, col) -> None:
    """Write ``text`` into ``img`` (in place) with its bottom-left pixel at
    ``org = (x, y)``, clipped to the image."""
    h, w = img.shape[:2]
    x0, y0, _, _ = text_box(text, org)
    for i, ch in enumerate(text):
        ys, xs = np.nonzero(_glyph(ch))
        ys, xs = ys + y0, xs + x0 + ADVANCE * i
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[ok], xs[ok]] = col


def polylines(img: np.ndarray, poly: np.ndarray, col, thickness: int = 2) -> None:
    """Draw the closed polygon ``poly [n, 2]`` (x, y) into ``img`` in place:
    every pixel whose centre is within ``(thickness + 1) / 2`` of an edge."""
    h, w = img.shape[:2]
    r = (max(thickness, 1) + 1) / 2.0
    pts = np.asarray(poly, np.float64).reshape(-1, 2)
    for a, b in zip(pts, np.roll(pts, -1, 0)):
        lo = np.floor(np.minimum(a, b) - r).astype(int)
        hi = np.ceil(np.maximum(a, b) + r).astype(int)
        x0, y0 = max(lo[0], 0), max(lo[1], 0)
        x1, y1 = min(hi[0], w - 1), min(hi[1], h - 1)
        if x1 < x0 or y1 < y0:
            continue
        yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
        d = b - a
        n2 = float(d @ d)
        t = (np.clip(((xx - a[0]) * d[0] + (yy - a[1]) * d[1]) / n2, 0.0, 1.0)
             if n2 > 0 else np.zeros(xx.shape))
        dist2 = (xx - a[0] - t * d[0]) ** 2 + (yy - a[1] - t * d[1]) ** 2
        img[y0:y1 + 1, x0:x1 + 1][dist2 <= r * r] = col


def label_origin(poly: np.ndarray):
    """Where the JAX ``draw_rboxes`` puts a box's label (``poly``: the int32
    corners ``[4, 2]``)."""
    return int(poly[:, 0].min()), max(int(poly[:, 1].min()) - 3, 10)


def draw_rboxes(img: np.ndarray, rboxes, classes=None, scores=None,
                names: Optional[Sequence[str]] = None, thickness: int = 2):
    """Draw rotated boxes ``[N, 5]`` onto a copy of ``img`` (BGR uint8, the
    colours taken as BGR, as cv2 takes them) and return it; a label where
    ``names`` or ``scores`` is given."""
    img = img.copy()
    rboxes = np.asarray(rboxes, np.float64).reshape(-1, 5)
    polys = rbox_vertices_np(rboxes).astype(np.int32)
    for k, poly in enumerate(polys):
        cid = int(classes[k]) if classes is not None else 0
        polylines(img, poly, color(cid), thickness)
        if names is not None or scores is not None:
            label = names[cid] if names is not None else str(cid)
            if scores is not None:
                label += f" {float(scores[k]):.2f}"
            put_text(img, label, label_origin(poly), color(cid))
    return img
