"""Double-precision polygon IoU (NumPy, CPU): the oracle of the evaluator
and the cross-chip merger.

A copy of ``s2anet_tpu/ops/polyiou_ref.py``: Sutherland–Hodgman clipping
of one convex polygon against the half-planes of the other, then the
shoelace formula. :func:`iou_poly` and :func:`box_iou_rotated_np` run the
C++ twin (:mod:`..native`) where a host compiler is found, and the NumPy
loops below otherwise; the ``*_np`` functions are the NumPy loops alone.
"""

from __future__ import annotations

import numpy as np

from .. import native


def _cross2(a, b) -> float:
    return float(a[0] * b[1] - a[1] * b[0])


def polygon_area(poly: np.ndarray) -> float:
    """Signed shoelace area; positive for counter-clockwise order (math coords)."""
    x = poly[:, 0]
    y = poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _ensure_ccw(poly: np.ndarray) -> np.ndarray:
    return poly if polygon_area(poly) >= 0 else poly[::-1]


def clip_polygon(subject: np.ndarray, clipper: np.ndarray) -> np.ndarray:
    """Clip convex polygon ``subject`` by convex polygon ``clipper`` (both
    ``[N, 2]``), both reordered counter-clockwise first. Returns the
    (possibly empty) intersection polygon."""
    subject = _ensure_ccw(np.asarray(subject, dtype=np.float64))
    clipper = _ensure_ccw(np.asarray(clipper, dtype=np.float64))
    output = list(subject)
    n = len(clipper)
    for i in range(n):
        if not output:
            return np.zeros((0, 2))
        a = clipper[i]
        b = clipper[(i + 1) % n]
        edge = b - a
        input_pts = output
        output = []
        for j, cur in enumerate(input_pts):
            prev = input_pts[j - 1]
            cur_in = _cross2(edge, cur - a) >= 0
            prev_in = _cross2(edge, prev - a) >= 0
            if cur_in:
                if not prev_in:
                    output.append(_line_intersect(prev, cur, a, b))
                output.append(cur)
            elif prev_in:
                output.append(_line_intersect(prev, cur, a, b))
    return np.asarray(output).reshape(-1, 2)


def _line_intersect(p1, p2, a, b):
    d1 = p2 - p1
    d2 = b - a
    denom = _cross2(d2, d1)
    if abs(denom) < 1e-300:
        return p2
    t = _cross2(d2, p1 - a) / -denom
    return p1 + d1 * t


def poly_intersection_area(poly1: np.ndarray, poly2: np.ndarray) -> float:
    inter = clip_polygon(poly1, poly2)
    if len(inter) < 3:
        return 0.0
    return abs(polygon_area(inter))


def iou_poly_np(poly1, poly2) -> float:
    """IoU of two convex polygons (``[N, 2]`` or flat ``[2N]``), NumPy."""
    p1 = np.asarray(poly1, dtype=np.float64).reshape(-1, 2)
    p2 = np.asarray(poly2, dtype=np.float64).reshape(-1, 2)
    a1 = abs(polygon_area(_ensure_ccw(p1)))
    a2 = abs(polygon_area(_ensure_ccw(p2)))
    inter = poly_intersection_area(p1, p2)
    union = a1 + a2 - inter
    if union <= 0:
        return 0.0
    return inter / union


def iou_poly(poly1, poly2) -> float:
    """IoU of two convex polygons: the C++ library where it is built."""
    if native.AVAILABLE:
        return native.iou_poly(poly1, poly2)
    return iou_poly_np(poly1, poly2)


def rbox_vertices_np(rboxes: np.ndarray) -> np.ndarray:
    """``[N, 5]`` rotated boxes -> ``[N, 4, 2]`` vertices, in the vertex
    order of :func:`.rbox.rbox_vertices`."""
    rb = np.asarray(rboxes, dtype=np.float64).reshape(-1, 5)
    x, y, w, h, a = rb[:, 0], rb[:, 1], rb[:, 2], rb[:, 3], rb[:, 4]
    c2 = np.cos(a) * 0.5
    s2 = np.sin(a) * 0.5
    p0 = np.stack([x - s2 * h - c2 * w, y + c2 * h - s2 * w], axis=-1)
    p1 = np.stack([x + s2 * h - c2 * w, y - c2 * h - s2 * w], axis=-1)
    ctr = np.stack([x, y], axis=-1)
    p2 = 2 * ctr - p0
    p3 = 2 * ctr - p1
    return np.stack([p0, p1, p2, p3], axis=1)


def box_iou_rotated_loops(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise rotated-box IoU ``[N, M]`` in double precision, NumPy."""
    b1 = np.asarray(boxes1, dtype=np.float64).reshape(-1, 5)
    b2 = np.asarray(boxes2, dtype=np.float64).reshape(-1, 5)
    v1 = rbox_vertices_np(b1)
    v2 = rbox_vertices_np(b2)
    a1 = b1[:, 2] * b1[:, 3]
    a2 = b2[:, 2] * b2[:, 3]
    out = np.zeros((len(b1), len(b2)), dtype=np.float64)
    for i in range(len(b1)):
        if a1[i] < 1e-14:
            continue
        for j in range(len(b2)):
            if a2[j] < 1e-14:
                continue
            inter = poly_intersection_area(v1[i], v2[j])
            out[i, j] = inter / (a1[i] + a2[j] - inter)
    return out


def box_iou_rotated_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise rotated-box IoU ``[N, M]``: the C++ library where it is built."""
    if native.AVAILABLE:
        return native.rbox_iou_matrix(boxes1, boxes2)
    return box_iou_rotated_loops(boxes1, boxes2)
