"""Rotated-box geometry on tensors.

Counterpart of ``s2anet_tpu/ops/rbox.py``. A rotated box is
``(x_ctr, y_ctr, w, h, theta)`` in pixels; ``w`` is the long side and
``theta`` (radians, clockwise-positive with y down) lies in
``[-pi/4, 3*pi/4)``. Deltas rotate the xy offset into the anchor frame,
keep wh in log space and divide the angle by pi.
"""

from __future__ import annotations

import math

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
