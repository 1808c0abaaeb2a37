"""Drawing without cv2 or matplotlib: the port of
``s2anet_tpu/utils/plots.py`` in NumPy, writing PNG.

**Detections.** :func:`draw_rboxes` draws each rotated box as its closed
polygon (the corners of :func:`..ops.polyiou.rbox_vertices_np` cast to
int32, as the JAX function hands them to ``cv2.polylines``): a pixel takes
the class's colour where its centre lies within ``(thickness + 1) / 2`` of
an edge, the round-capped stroke cv2 draws (3 pixels wide at thickness 2).
Within the image every pixel either colours lies within one pixel of one
the other colours; on the image's border row or column, where an edge runs
past the image, cv2's clipped fill reaches up to about 1.9 pixels from the
edge. The label (class name, score to two places) is written where the
JAX function puts it, ``(min x, max(min y - 3, 10))`` as the text's
bottom-left, in a built-in 5 x 7 bitmap font (:mod:`.figure`), where cv2
draws Hershey glyphs: the pixels of the text are not cv2's.

**Training plots.** :func:`plot_images_grid` (the first batches' mosaic),
:func:`plot_label_stats` (``labels.png``), :func:`plot_pr_curves`
(``pr_curves.png``) and :func:`plot_results_csv` (``results.png``) take
the JAX functions' arguments. The mosaic is the JAX one's, resized with
:func:`..data.augment.resize_bilinear` (within one level of
``cv2.resize``), written as PNG where the JAX function writes JPEG. The
other three draw with :mod:`.figure` at matplotlib's pixel size
(``figsize`` at 120 dpi); each computes what it draws in a function of its
own (:func:`label_stats_data`, :func:`pr_curves_data`,
:func:`results_csv_data`): the same bins, counts, curve points and legend
strings as matplotlib is handed in the JAX function. No plot catches an
error.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..data.augment import resize_bilinear
from ..data.synth import write_png
from ..ops.polyiou import rbox_vertices_np
from .figure import CYCLE, Figure, blend, polylines, put_text, save, text_box  # noqa: F401

# the JAX package's (Ultralytics-style) palette
_PALETTE = [
    (255, 56, 56), (255, 157, 151), (255, 112, 31), (255, 178, 29),
    (207, 210, 49), (72, 249, 10), (146, 204, 23), (61, 219, 134),
    (26, 147, 52), (0, 212, 187), (44, 153, 168), (0, 194, 255),
    (52, 69, 147), (100, 115, 255), (0, 24, 236), (132, 56, 255),
]

def color(i: int):
    return _PALETTE[i % len(_PALETTE)]


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


def plot_images_grid(imgs: np.ndarray, targets_per_img, save_path,
                     names=None, max_images: int = 16, max_size: int = 640):
    """Mosaic of a training batch with its rotated gt boxes: ``imgs`` ``[B,
    H, W, 3]`` uint8 RGB, ``targets_per_img`` per image ``(boxes [n, 5],
    classes [n])`` in its pixels. ``n = ceil(sqrt(B))`` tiles a side on
    white, each scaled by ``min(max_size / max(H, W), 1)``; written as an
    RGB PNG; returns the BGR mosaic, as the JAX function does."""
    b = min(len(imgs), max_images)
    n = int(np.ceil(np.sqrt(b)))
    h, w = imgs.shape[1:3]
    scale = min(max_size / max(h, w), 1.0)
    hs, ws = int(h * scale), int(w * scale)
    mosaic = np.full((n * hs, n * ws, 3), 255, np.uint8)
    for k in range(b):
        img = np.ascontiguousarray(imgs[k, :, :, ::-1])  # RGB -> BGR
        boxes, classes = targets_per_img[k]
        if scale != 1.0:
            img = resize_bilinear(img, (ws, hs))
            boxes = np.asarray(boxes, np.float64).copy()
            if len(boxes):
                boxes[:, :4] *= scale
        img = draw_rboxes(img, boxes, classes, names=names, thickness=1)
        r, c = divmod(k, n)
        mosaic[r * hs:(r + 1) * hs, c * ws:(c + 1) * ws] = img
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    write_png(save_path, mosaic[:, :, ::-1])
    return mosaic


def label_stats_data(all_boxes: np.ndarray, all_classes: np.ndarray,
                     num_classes: int = 15) -> dict:
    """The panels of :func:`plot_label_stats`: ``classes`` (counts, edges)
    over bins ``arange(num_classes + 1) - 0.5``; with boxes, ``xy`` and
    ``wh`` (counts ``[50, 50]``, x edges, y edges) and ``theta`` (counts,
    edges; 60 bins)."""
    out = {"classes": np.histogram(all_classes, bins=np.arange(num_classes + 1) - 0.5)}
    if len(all_boxes):
        out["xy"] = np.histogram2d(all_boxes[:, 0], all_boxes[:, 1], bins=50)
        out["wh"] = np.histogram2d(all_boxes[:, 2], all_boxes[:, 3], bins=50)
        out["theta"] = np.histogram(all_boxes[:, 4], bins=60)
    return out


def _hist_panel(ax, counts, edges, title):
    pad = 0.05 * (edges[-1] - edges[0])
    ax.set_xlim(edges[0] - pad, edges[-1] + pad)
    ax.set_ylim(0, 1.05 * max(float(np.max(counts)), 1.0))
    ax.bars(edges, counts)
    ax.frame(title)


def plot_label_stats(all_boxes: np.ndarray, all_classes: np.ndarray,
                     save_path, num_classes: int = 15):
    """Label distributions, 2 x 2 panels on 1200 x 960 pixels: the class
    histogram, the x-y and w-h 2-D histograms and the angle histogram."""
    data = label_stats_data(all_boxes, all_classes, num_classes)
    fig = Figure((10, 8))
    axes = fig.subplots(2, 2)
    _hist_panel(axes[0][0], *data["classes"], "classes")
    for ax, key, title in ((axes[0][1], "xy", "xy centers"), (axes[1][0], "wh", "wh")):
        if key in data:
            counts, xe, ye = data[key]
            ax.set_xlim(xe[0], xe[-1])
            ax.set_ylim(ye[0], ye[-1])
            ax.image(counts, xe, ye)
            ax.frame(title)
        else:
            ax.frame()
    if "theta" in data:
        _hist_panel(axes[1][1], *data["theta"], "theta")
    else:
        axes[1][1].frame()
    save(fig, save_path)


def pr_curves_data(per_class_results: dict) -> list:
    """``(rec, prec, legend label)`` of each class with a curve, in order:
    the label ``"<class> <ap:.3f>"``."""
    return [(np.asarray(res["rec"]), np.asarray(res["prec"]), f"{cname} {res['ap']:.3f}")
            for cname, res in per_class_results.items() if len(res["rec"])]


def plot_pr_curves(per_class_results: dict, save_path):
    """Each class's precision-recall curve on 960 x 720 pixels, axes [0, 1]
    x [0, 1.02], a legend of the classes and their AP at the lower left."""
    fig = Figure((8, 6))
    ax = fig.subplots(1, 1)[0][0]
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    for i, (rec, prec, label) in enumerate(pr_curves_data(per_class_results)):
        ax.line(rec, prec, blend(CYCLE[i % len(CYCLE)], 0.6), label=label)
    ax.frame(xlabel="Recall", ylabel="Precision")
    ax.legend()
    save(fig, save_path)


def results_csv_data(csv_path):
    """``(xs, {key: ys or None})`` of ``results.csv``, every column but
    ``epoch_or_step`` in order; ``ys`` None where a cell does not parse as
    a float (an epoch without validation leaves its metrics empty), as the
    JAX function skips such a column. None for a file without rows."""
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None
    xs = [float(row["epoch_or_step"]) for row in rows]
    cols = {}
    for k in (k for k in rows[0] if k != "epoch_or_step"):
        cells = [row[k] for row in rows]
        cols[k] = [float(v) for v in cells] if all(map(_is_float, cells)) else None
    return xs, cols


# what ``float()`` takes from a cell that the logger wrote
_FLOAT = re.compile(r"\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf(?:inity)?|nan)\s*",
                    re.IGNORECASE)


def _is_float(v) -> bool:
    return isinstance(v, str) and _FLOAT.fullmatch(v) is not None


def plot_results_csv(csv_path, save_path):
    """Training curves from ``results.csv``: one 480 x 360 panel a column
    (``epoch_or_step`` the x axis), 4 a row, titled by the key; a column
    with an empty cell leaves its panel empty; no file without rows."""
    data = results_csv_data(csv_path)
    if data is None:
        return
    xs, cols = data
    ncols = 4
    nrows = int(np.ceil(len(cols) / ncols))
    fig = Figure((4 * ncols, 3 * nrows))
    axes = fig.subplots(nrows, ncols)
    for i, (k, ys) in enumerate(cols.items()):
        ax = axes[i // ncols][i % ncols]
        if ys is None:
            ax.frame()
            continue
        ax.autoscale(xs, ys)
        ax.line(xs, ys, marker=True)
        ax.frame(k)
    for i in range(len(cols), nrows * ncols):
        axes[i // ncols][i % ncols].frame()
    save(fig, save_path)
