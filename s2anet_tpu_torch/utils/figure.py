"""Raster figures in NumPy: the axes, bars, 2-D histograms, curves and
legends of the training plots (:mod:`.plots`), drawn without matplotlib.

A :class:`Figure` is a white RGB ``[H, W, 3]`` uint8 canvas of
matplotlib's pixel size (``figsize x dpi``); :meth:`Figure.subplots`
splits it into a grid of :class:`Axes`. An axes maps data to pixels
inside its frame (y up) and draws the frame, about five ticks a side at
1, 2 or 5 times a power of ten with their values, its title and labels in
a 5 x 7 bitmap font (twice its size), bars, a
colour-mapped 2-D histogram, polylines with optional dot markers and a
legend. The pixels are this module's own: only the figure's size and the
data drawn follow matplotlib. :func:`put_text` and :func:`polylines` also
draw the detections of :mod:`.plots`.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import numpy as np

from ..data.synth import write_png

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
    ":": "000c0c000c0c00", " ": "00000000000000", "/": "00010204081000",
    "(": "02040808080402", ")": "08040202020408", "+": "0004041f040400",
    ",": "00000000000c04", "=": "00001f001f0000", "%": "18190204081303",
}
GLYPH_H, ADVANCE = 7, 6  # 5 x 7 glyphs a column apart


def _glyph(ch: str) -> np.ndarray:
    rows = bytes.fromhex(_FONT.get(ch.lower(), _FONT[" "]))
    return (np.array(list(rows), np.uint8)[:, None] >> np.arange(4, -1, -1)) & 1


def text_box(text: str, org, scale: int = 1):
    """``(x0, y0, x1, y1)``, the pixels (end exclusive) that
    :func:`put_text` may colour for ``text`` at ``org``."""
    x, y = org
    return x, y - GLYPH_H * scale + 1, x + ADVANCE * scale * len(text), y + 1


def put_text(img: np.ndarray, text: str, org, col, scale: int = 1) -> None:
    """Write ``text`` into ``img`` (in place) with its bottom-left pixel at
    ``org = (x, y)``, each glyph pixel a ``scale x scale`` square, clipped
    to the image."""
    h, w = img.shape[:2]
    x0, y0, _, _ = text_box(text, org, scale)
    for i, ch in enumerate(text):
        g = _glyph(ch)
        if scale > 1:
            g = np.kron(g, np.ones((scale, scale), np.uint8))
        ys, xs = np.nonzero(g)
        ys, xs = ys + y0, xs + x0 + ADVANCE * scale * i
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[ok], xs[ok]] = col


def polylines(img: np.ndarray, poly: np.ndarray, col, thickness: int = 2,
              closed: bool = True) -> None:
    """Draw the polygon ``poly [n, 2]`` (x, y) into ``img`` in place,
    closed or open: every pixel whose centre is within ``(thickness + 1) /
    2`` of an edge (a lone point: of the point)."""
    h, w = img.shape[:2]
    r = (max(thickness, 1) + 1) / 2.0
    pts = np.asarray(poly, np.float64).reshape(-1, 2)
    if len(pts) == 1:
        segments = [(pts[0], pts[0])]
    else:
        segments = zip(pts, np.roll(pts, -1, 0)) if closed else zip(pts[:-1], pts[1:])
    for a, b in segments:
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


# matplotlib's default colour cycle (tab10), RGB
CYCLE = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
         (140, 86, 75), (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207)]
# anchors of the 2-D histograms' colour map, low to high (dark blue to yellow)
_CMAP = np.array([(68, 1, 84), (59, 82, 139), (33, 145, 140), (94, 201, 98),
                  (253, 231, 37)], np.float64)
TEXT = 2  # font scale of titles, labels and tick values
DPI = 120
_MARGIN = (86, 24, 30, 44)  # an axes' frame inside its cell: left, right, top, bottom


def colormap(v: np.ndarray) -> np.ndarray:
    """Values in [0, 1] -> RGB uint8, piecewise linear over the anchors."""
    t = np.clip(np.asarray(v, np.float64), 0.0, 1.0) * (len(_CMAP) - 1)
    i = np.minimum(t.astype(int), len(_CMAP) - 2)
    f = (t - i)[..., None]
    return np.round(_CMAP[i] * (1 - f) + _CMAP[i + 1] * f).astype(np.uint8)


def nice_ticks(lo: float, hi: float, n: int = 5) -> np.ndarray:
    """About ``n`` ticks in ``[lo, hi]`` at a step of 1, 2 or 5 times a
    power of ten."""
    if not hi > lo:
        return np.array([lo])
    raw = (hi - lo) / n
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9)
    ticks = (first + np.arange(int(math.floor(hi / step + 1e-9)) - first + 1)) * step
    return np.round(ticks, max(0, -math.floor(math.log10(step))) + 1)


def tick_label(v: float) -> str:
    return f"{v:.4g}"


def blend(col, alpha: float):
    """``col`` drawn with ``alpha`` over white."""
    return tuple(int(round(alpha * c + (1 - alpha) * 255)) for c in col)


class Figure:
    def __init__(self, figsize, dpi: int = DPI):
        self.w, self.h = int(round(figsize[0] * dpi)), int(round(figsize[1] * dpi))
        self.img = np.full((self.h, self.w, 3), 255, np.uint8)

    def subplots(self, rows: int, cols: int):
        """``[rows][cols]`` axes, one a cell of an equal grid."""
        cw, ch = self.w / cols, self.h / rows
        return [[Axes(self.img, (int(c * cw), int(r * ch), int((c + 1) * cw),
                                 int((r + 1) * ch))) for c in range(cols)]
                for r in range(rows)]


class Axes:
    """A cell ``(x0, y0, x1, y1)`` of a figure's canvas; the frame lies
    inside it by the margins."""

    def __init__(self, img: np.ndarray, cell):
        self.img = img
        x0, y0, x1, y1 = cell
        self.cell = cell
        self.box = (x0 + _MARGIN[0], y0 + _MARGIN[2], x1 - _MARGIN[1], y1 - _MARGIN[3])
        self.xlim = self.ylim = (0.0, 1.0)
        self._legend = []

    # -- coordinates ---------------------------------------------------
    @staticmethod
    def _span(lo, hi):
        """``(lo, hi)``, widened by 0.5 each way where it is empty."""
        return (float(lo), float(hi)) if hi > lo else (float(lo) - 0.5, float(lo) + 0.5)

    def set_xlim(self, lo, hi):
        self.xlim = self._span(lo, hi)

    def set_ylim(self, lo, hi):
        self.ylim = self._span(lo, hi)

    def autoscale(self, xs, ys, margin: float = 0.05):
        """Limits around the data, ``margin`` of the span beyond each side."""
        for vals, setter in ((xs, self.set_xlim), (ys, self.set_ylim)):
            v = np.asarray(vals, np.float64)
            lo, hi = float(v.min()), float(v.max())
            pad = margin * (hi - lo)
            setter(lo - pad, hi + pad)

    def px(self, x, y):
        """Data -> pixel coordinates (float; y grows down)."""
        x0, y0, x1, y1 = self.box
        fx = (np.asarray(x, np.float64) - self.xlim[0]) / (self.xlim[1] - self.xlim[0])
        fy = (np.asarray(y, np.float64) - self.ylim[0]) / (self.ylim[1] - self.ylim[0])
        return x0 + fx * (x1 - x0), y1 - fy * (y1 - y0)

    def _rect(self, xa, xb, ya, yb, col):
        """Fill data rectangle ``[xa, xb] x [ya, yb]``, clipped to the frame."""
        bx0, by0, bx1, by1 = self.box
        (pa, pb), (qa, qb) = self.px([xa, xb], [ya, yb])
        c0, c1 = int(round(max(min(pa, pb), bx0))), int(round(min(max(pa, pb), bx1)))
        r0, r1 = int(round(max(min(qa, qb), by0))), int(round(min(max(qa, qb), by1)))
        if c1 > c0 and r1 > r0:
            self.img[r0:r1, c0:c1] = col

    # -- marks ---------------------------------------------------------
    def bars(self, edges, counts, col=CYCLE[0]):
        """A histogram: a bar of height ``counts[i]`` over ``[edges[i],
        edges[i+1]]``."""
        for a, b, c in zip(edges[:-1], edges[1:], counts):
            if c > 0:
                self._rect(a, b, 0.0, c, col)

    def image(self, counts, xedges, yedges):
        """A 2-D histogram ``counts [len(xedges)-1, len(yedges)-1]`` as
        coloured cells (x right, y up), scaled to its largest count."""
        top = max(float(np.max(counts)), 1.0)
        cols = colormap(np.asarray(counts, np.float64) / top)
        for i in range(len(xedges) - 1):
            for j in range(len(yedges) - 1):
                self._rect(xedges[i], xedges[i + 1], yedges[j], yedges[j + 1], cols[i, j])

    def line(self, xs, ys, col=CYCLE[0], marker: bool = False, label: Optional[str] = None):
        px, py = self.px(xs, ys)
        pts = np.stack([px, py], 1)
        x0, y0, x1, y1 = self.box
        frame = self.img[y0:y1 + 1, x0:x1 + 1]
        local = pts - (x0, y0)
        for a, b in zip(local[:-1], local[1:]):
            polylines(frame, np.stack([a, b]), col, 1, closed=False)
        if marker:
            for x, y in local:
                polylines(frame, np.array([[x, y]]), col, 4, closed=False)
        if label is not None:
            self._legend.append((label, col))

    # -- furniture -----------------------------------------------------
    def text(self, s: str, x: int, y: int, col=(0, 0, 0), scale: int = TEXT,
             anchor: str = "left"):
        """``s`` with its bottom at row ``y``; ``x`` its left edge, centre
        or right edge by ``anchor``."""
        x0, _, x1, _ = text_box(s, (0, 0), scale)
        shift = {"left": 0, "center": (x1 - x0) // 2, "right": x1 - x0}[anchor]
        put_text(self.img, s, (x - shift, y), col, scale)

    def frame(self, title: str = "", xlabel: str = "", ylabel: str = ""):
        """The frame, ticks with their values, title and axis labels."""
        x0, y0, x1, y1 = self.box
        k = (0, 0, 0)
        self.img[y0, x0:x1 + 1] = k
        self.img[y1, x0:x1 + 1] = k
        self.img[y0:y1 + 1, x0] = k
        self.img[y0:y1 + 1, x1] = k
        for t in nice_ticks(*self.xlim):
            px = int(round(float(self.px(t, self.ylim[0])[0])))
            if x0 <= px <= x1:
                self.img[y1:y1 + 5, px] = k
                self.text(tick_label(t), px, y1 + 7 + 7 * TEXT, anchor="center")
        for t in nice_ticks(*self.ylim):
            py = int(round(float(self.px(self.xlim[0], t)[1])))
            if y0 <= py <= y1:
                self.img[py, x0 - 4:x0 + 1] = k
                self.text(tick_label(t), x0 - 7, py + 3 * TEXT, anchor="right")
        if title:
            self.text(title, (x0 + x1) // 2, y0 - 8, anchor="center")
        if xlabel:
            self.text(xlabel, (x0 + x1) // 2, self.cell[3] - 4, anchor="center")
        if ylabel:  # above the y ticks' values
            self.text(ylabel, self.cell[0] + 4, y0 - 8)

    def legend(self):
        """The labelled lines' entries in a box at the lower left, in the
        font's own size."""
        if not self._legend:
            return
        x0, _, _, y1 = self.box
        row = GLYPH_H + 5
        width = max(len(s) for s, _ in self._legend) * ADVANCE + 34
        top = y1 - 6 - row * len(self._legend) - 4
        bx0, by0, bx1, by1 = x0 + 6, top, x0 + 6 + width, y1 - 6
        self.img[by0:by1, bx0:bx1] = 255
        self.img[by0, bx0:bx1] = self.img[by1 - 1, bx0:bx1] = (200, 200, 200)
        self.img[by0:by1, bx0] = self.img[by0:by1, bx1 - 1] = (200, 200, 200)
        for i, (s, col) in enumerate(self._legend):
            y = by0 + 4 + row * (i + 1) - 3
            self.img[y - 3:y - 1, bx0 + 6:bx0 + 24] = col
            self.text(s, bx0 + 30, y, scale=1)


def save(fig: Figure, path) -> None:
    """The figure as an RGB PNG (parents made)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_png(path, fig.img)
