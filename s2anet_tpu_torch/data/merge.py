"""Cross-chip detection merging with polygon NMS.

A copy of ``s2anet_tpu/data/merge.py``:

  * a chip name ``origname__rate__left___up`` is inverted: chip-local
    polygons are shifted by (left, up) and scaled by 1/rate back into
    full-image coordinates;
  * per full image and class, greedy polygon NMS at ``iou_thr`` (strict
    ``>``), in stable score order, with an axis-aligned-bbox prefilter;
    polygon IoU is the double-precision oracle (:mod:`..ops.polyiou`), and
    the whole NMS runs in the C++ library where it is built.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import native
from ..ops.polyiou import iou_poly_np

_CHIP_RE = re.compile(r"^(.*?)__([\d.]+)__(\d+)___(\d+)$")


def parse_chip_name(chip_name: str) -> Tuple[str, float, float, float]:
    """'P0001__1.0__824___0' -> ('P0001', 1.0, 824.0, 0.0)."""
    m = _CHIP_RE.match(chip_name)
    if not m:
        return chip_name, 1.0, 0.0, 0.0
    return m.group(1), float(m.group(2)), float(m.group(3)), float(m.group(4))


def chip_to_image_coords(polys: np.ndarray, chip_name: str) -> np.ndarray:
    """Shift/scale chip-local [N, 8] polygons to full-image coordinates."""
    name, rate, left, up = parse_chip_name(chip_name)
    polys = np.asarray(polys, dtype=np.float64).reshape(-1, 8).copy()
    polys[:, 0::2] += left
    polys[:, 1::2] += up
    polys /= rate
    return polys


def poly_nms_loops(polys: np.ndarray, scores: np.ndarray, iou_thr: float = 0.5):
    """:func:`poly_nms_np` in NumPy loops."""
    polys = np.asarray(polys, dtype=np.float64).reshape(-1, 8)
    n = len(polys)
    xs = polys[:, 0::2]
    ys = polys[:, 1::2]
    x1, x2 = xs.min(1), xs.max(1)
    y1, y2 = ys.min(1), ys.max(1)
    order = np.argsort(-np.asarray(scores), kind="stable")
    alive = np.ones(n, bool)
    keep = []
    for pos, i in enumerate(order):
        if not alive[i]:
            continue
        keep.append(int(i))
        for j in order[pos + 1:]:
            if not alive[j]:
                continue
            # hbb prefilter
            iw = min(x2[i], x2[j]) - max(x1[i], x1[j])
            ih = min(y2[i], y2[j]) - max(y1[i], y1[j])
            if iw <= 0 or ih <= 0:
                continue
            if iou_poly_np(polys[i], polys[j]) > iou_thr:
                alive[j] = False
    return keep


def poly_nms_np(polys: np.ndarray, scores: np.ndarray, iou_thr: float = 0.5):
    """Greedy polygon NMS; returns kept indices in score order."""
    polys = np.asarray(polys, dtype=np.float64).reshape(-1, 8)
    if len(polys) == 0:
        return []
    if native.AVAILABLE:
        return native.poly_nms(polys, scores, iou_thr)
    return poly_nms_loops(polys, scores, iou_thr)


def merge_chip_detections(
    chip_dets: Dict[str, Sequence],
    iou_thr: float = 0.5,
) -> Dict[str, List]:
    """Merge per-chip detections into per-full-image detections.

    Args:
      chip_dets: {chip_name: iterable of (class_id, score, poly[8])} with
        polygons in chip-local coordinates.
      iou_thr: cross-chip polygon NMS threshold.

    Returns:
      {image_name: [(class_id, score, poly[8] in image coords), ...]} after
      per-class polygon NMS.
    """
    per_image = defaultdict(lambda: defaultdict(list))
    for chip_name, dets in chip_dets.items():
        img_name, rate, left, up = parse_chip_name(chip_name)
        for cls_id, score, poly in dets:
            p = np.asarray(poly, dtype=np.float64).reshape(8).copy()
            p[0::2] += left
            p[1::2] += up
            p /= rate
            per_image[img_name][int(cls_id)].append((float(score), p))

    out: Dict[str, List] = {}
    for img_name, by_cls in per_image.items():
        merged = []
        for cls_id, items in by_cls.items():
            scores = np.array([s for s, _ in items])
            polys = np.stack([p for _, p in items])
            keep = poly_nms_np(polys, scores, iou_thr)
            for k in keep:
                merged.append((cls_id, float(scores[k]), polys[k]))
        out[img_name] = merged
    return out
