"""Rotated-box geometry on tensors.

Counterpart of ``s2anet_tpu/ops/rbox.py``. A rotated box is
``(x_ctr, y_ctr, w, h, theta)`` in pixels; ``w`` is the long side and
``theta`` (radians, clockwise-positive with y down) lies in
``[-pi/4, 3*pi/4)``. Deltas rotate the xy offset into the anchor frame,
keep wh in log space and divide the angle by pi.

The NumPy half (:func:`poly_to_rbox_np`) turns label polygons into rotated
boxes on the host, as the JAX module's NumPy functions do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi


def norm_angle(angle):
    """Normalize angle(s) into ``[-pi/4, 3*pi/4)``."""
    return torch.remainder(angle + PI / 4, PI) - PI / 4


def rbox_vertices(rboxes: torch.Tensor) -> torch.Tensor:
    """``[..., 5]`` boxes -> ``[..., 4, 2]`` corners; consecutive corners
    share an edge, p2/p3 are the central reflections of p0/p1."""
    x, y, w, h, a = rboxes.unbind(-1)
    c2 = torch.cos(a) * 0.5
    s2 = torch.sin(a) * 0.5
    p0 = torch.stack([x - s2 * h - c2 * w, y + c2 * h - s2 * w], -1)
    p1 = torch.stack([x + s2 * h - c2 * w, y - c2 * h - s2 * w], -1)
    ctr2 = torch.stack([2 * x, 2 * y], -1)
    return torch.stack([p0, p1, ctr2 - p0, ctr2 - p1], -2)


def rbox_to_poly(rboxes: torch.Tensor) -> torch.Tensor:
    """``[..., 5]`` boxes -> ``[..., 8]`` polygons (x0, y0, ..., x3, y3)."""
    verts = rbox_vertices(rboxes)
    return verts.reshape(*verts.shape[:-2], 8)


def rboxes_encode(anchors: torch.Tensor, gt_rboxes: torch.Tensor) -> torch.Tensor:
    """Deltas ``[..., 5]`` of ``gt_rboxes`` against ``anchors`` (both
    ``[..., 5]``, broadcast): the xy offset rotated into the anchor frame and
    divided by the anchor's w/h, log wh ratios, and ``norm_angle`` of the
    angle difference over pi."""
    ax, ay, aw, ah, aa = anchors.unbind(-1)
    gx, gy, gw, gh, ga = gt_rboxes.unbind(-1)
    ox = gx - ax
    oy = gy - ay
    cosa = torch.cos(aa)
    sina = torch.sin(aa)
    dx = (cosa * ox + sina * oy) / aw
    dy = (-sina * ox + cosa * oy) / ah
    dw = torch.log(gw / aw)
    dh = torch.log(gh / ah)
    da = norm_angle(ga - aa) / PI
    return torch.stack([dx, dy, dw, dh, da], -1)


def rboxes_decode(anchors: torch.Tensor, deltas: torch.Tensor,
                  wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """Decode ``[..., 5]`` deltas against ``[..., 5]`` anchors.

    dw/dh are clamped to ``|log(wh_ratio_clip)|``; the anchor refinement
    passes ``wh_ratio_clip=1e-6``, the final decode the default.
    """
    ax, ay, aw, ah, aa = anchors.unbind(-1)
    dx, dy, dw, dh, da = deltas.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    cosa = torch.cos(aa)
    sina = torch.sin(aa)
    gx = dx * aw * cosa - dy * ah * sina + ax
    gy = dx * aw * sina + dy * ah * cosa + ay
    gw = aw * torch.exp(dw)
    gh = ah * torch.exp(dh)
    ga = norm_angle(PI * da + aa)
    return torch.stack([gx, gy, gw, gh, ga], -1)


def norm_angle_np(angle):
    """:func:`norm_angle` for NumPy arrays and Python floats."""
    return (angle + PI / 4) % PI - PI / 4


def poly_to_rbox_np(polys: np.ndarray) -> np.ndarray:
    """``[N, 8]`` polygons -> ``[N, 5]`` rotated boxes (NumPy, data plane).

    Minimum-area enclosing rectangle of the 4 points via rotating calipers
    over the convex hull, long side first, theta normalized to
    ``[-pi/4, 3pi/4)``; float precision (no integer cast of the corners).
    """
    polys = np.asarray(polys, dtype=np.float64).reshape(-1, 8)
    out = np.zeros((polys.shape[0], 5), dtype=np.float64)
    for i, p in enumerate(polys):
        out[i] = _min_area_rect(p.reshape(4, 2))
    return out


def _min_area_rect(pts: np.ndarray) -> np.ndarray:
    """Minimum-area rectangle of a point set; returns (x, y, w_long, h_short, theta).

    The JAX package's arithmetic, operation for operation, on Python floats
    (IEEE doubles, as NumPy's float64 scalars; ``np.hypot`` kept): the same
    bits at a tenth of the time of tiny-array NumPy calls."""
    hull = _convex_hull(pts)
    n = len(hull)
    if n == 1:
        return np.array([hull[0][0], hull[0][1], 0.0, 0.0, 0.0])
    if n == 2:
        dx, dy = hull[1][0] - hull[0][0], hull[1][1] - hull[0][1]
        cx, cy = (hull[0][0] + hull[1][0]) / 2, (hull[0][1] + hull[1][1]) / 2
        return np.array([cx, cy, float(np.hypot(dx, dy)), 0.0,
                         norm_angle_np(math.atan2(dy, dx))])
    best = None
    for k in range(n):
        (ax, ay), (bx, by) = hull[k], hull[(k + 1) % n]
        ex, ey = bx - ax, by - ay
        ln = float(np.hypot(ex, ey))
        if ln < 1e-12:
            continue
        ux, uy = ex / ln, ey / ln  # edge direction
        # the hull in the edge frame
        xs = [hx * ux + hy * uy for hx, hy in hull]
        ys = [-hx * uy + hy * ux for hx, hy in hull]
        x0, x1 = min(xs), max(xs)
        y0, y1 = min(ys), max(ys)
        area = (x1 - x0) * (y1 - y0)
        if best is None or area < best[0]:
            cx_e, cy_e = (x0 + x1) / 2, (y0 + y1) / 2
            # back to image frame
            cx = cx_e * ux - cy_e * uy
            cy = cx_e * uy + cy_e * ux
            best = (area, cx, cy, x1 - x0, y1 - y0, math.atan2(uy, ux))
    _, cx, cy, w, h, ang = best
    if h > w:
        w, h = h, w
        ang += PI / 2
    return np.array([cx, cy, w, h, float(norm_angle_np(ang))])


def _convex_hull(pts: np.ndarray):
    """Andrew's monotone-chain convex hull (counter-clockwise in math
    coords) of the distinct points, as a list of (x, y)."""
    pts = sorted(set(map(tuple, np.asarray(pts, np.float64).tolist())))
    if len(pts) <= 2:
        return pts

    def half(points):
        h = []
        for p in points:
            while len(h) >= 2 and (h[-1][0] - h[-2][0]) * (p[1] - h[-2][1]) - (
                    h[-1][1] - h[-2][1]) * (p[0] - h[-2][0]) <= 0:
                h.pop()
            h.append(p)
        return h

    lower = half(pts)
    upper = half(pts[::-1])
    return lower[:-1] + upper[:-1]
