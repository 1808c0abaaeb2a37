"""Rotated-box geometry of the plain reference, in float32 PyTorch.

Frozen copies of the detector's published geometry: the anchor grid (one
anchor a cell, scale 4, ratio 1, angle 0, centres at ``0.5 * (stride - 1)``
past each cell origin), the delta coding of rotated boxes, the AlignConv
sampling offsets, the Active Rotating Filter permutation, and the pairwise
rotated IoU (a sort-free tally of each box's edges inside the other).
Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi


def norm_angle(angle):
    return torch.remainder(angle + PI / 4, PI) - PI / 4


def grid_anchors(h: int, w: int, stride: int, device) -> torch.Tensor:
    """``[H*W, 5]`` anchors (x, y, w, h, theta) in (h, w) row-major order."""
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride + 0.5 * (stride - 1)
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride + 0.5 * (stride - 1)
    ctr = torch.stack([xs.repeat(h), ys.repeat_interleave(w)], 1)
    size = torch.full((h * w, 1), 4.0 * stride, device=device)
    return torch.cat([ctr, size, size, torch.zeros(h * w, 1, device=device)], 1)


def rboxes_encode(anchors, gt):
    ax, ay, aw, ah, aa = anchors.unbind(-1)
    gx, gy, gw, gh, ga = gt.unbind(-1)
    ox, oy = gx - ax, gy - ay
    cosa, sina = torch.cos(aa), torch.sin(aa)
    return torch.stack([(cosa * ox + sina * oy) / aw, (-sina * ox + cosa * oy) / ah,
                        torch.log(gw / aw), torch.log(gh / ah),
                        norm_angle(ga - aa) / PI], -1)


def rboxes_decode(anchors, deltas, wh_ratio_clip: float = 16 / 1000):
    ax, ay, aw, ah, aa = anchors.unbind(-1)
    dx, dy, dw, dh, da = deltas.unbind(-1)
    r = abs(math.log(wh_ratio_clip))
    dw, dh = dw.clamp(-r, r), dh.clamp(-r, r)
    cosa, sina = torch.cos(aa), torch.sin(aa)
    return torch.stack([dx * aw * cosa - dy * ah * sina + ax,
                        dx * aw * sina + dy * ah * cosa + ay,
                        aw * torch.exp(dw), ah * torch.exp(dh),
                        norm_angle(PI * da + aa)], -1)


def align_offsets(anchors, h: int, w: int, stride: float) -> torch.Tensor:
    """``[B, H, W, 9, 2]`` (dy, dx) offsets that move each 3x3 tap of a
    cell onto the refined anchor's rotated 3x3 grid (anchors ``[B, H*W, 5]``)."""
    dev = anchors.device
    idx = torch.arange(-1, 2, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(idx, idx, indexing="ij")
    xx, yy = xx.reshape(-1), yy.reshape(-1)
    yc, xc = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    x_conv = xc.reshape(-1)[:, None] + xx[None, :]
    y_conv = yc.reshape(-1)[:, None] + yy[None, :]
    x_ctr, y_ctr, aw, ah, a = anchors.unbind(-1)
    x_ctr, y_ctr, aw, ah = x_ctr / stride, y_ctr / stride, aw / stride, ah / stride
    cos, sin = torch.cos(a)[..., None], torch.sin(a)[..., None]
    xk = (aw / 3)[..., None] * xx
    yk = (ah / 3)[..., None] * yy
    x_anchor = cos * xk - sin * yk + x_ctr[..., None]
    y_anchor = sin * xk + cos * yk + y_ctr[..., None]
    off = torch.stack([y_anchor - y_conv, x_anchor - x_conv], -1)
    return off.reshape(anchors.shape[0], h, w, 9, 2)


# 45-degree rotations of a 3x3 kernel as 1-indexed source taps (the ORN table)
_ROT3 = {0: (1, 2, 3, 4, 5, 6, 7, 8, 9), 45: (2, 3, 6, 1, 5, 9, 4, 7, 8),
         90: (3, 6, 9, 2, 5, 8, 1, 4, 7), 135: (6, 9, 8, 3, 5, 7, 2, 1, 4),
         180: (9, 8, 7, 6, 5, 4, 3, 2, 1), 225: (8, 7, 4, 9, 5, 1, 6, 3, 2),
         270: (7, 4, 1, 8, 5, 2, 9, 6, 3), 315: (4, 1, 2, 7, 5, 3, 8, 9, 6)}


def rotate_arf(weight: torch.Tensor, n_rot: int = 8) -> torch.Tensor:
    """``[Cout, Cin, 1, 3, 3]`` -> ``[Cout*n_rot, Cin, 3, 3]``: copy ``k`` of
    each filter is the filter turned by ``45 k`` degrees; rotation is the
    fastest output channel."""
    cout, cin, n_orient, kh, kw = weight.shape
    kk = kh * kw
    gather = np.zeros((n_rot, n_orient * kk), np.int64)
    for o in range(n_orient):
        for j in range(kk):
            for k in range(n_rot):
                angle = (360 // n_rot * k) % 360
                layer = (o + angle // (360 // n_orient)) % n_orient
                gather[k, layer * kk + _ROT3[angle][j] - 1] = o * kk + j
    flat = weight.reshape(cout, cin, n_orient * kk)
    out = flat[:, :, torch.from_numpy(gather).to(weight.device)].transpose(1, 2)
    return out.reshape(cout * n_rot, cin * n_orient, kh, kw)


_PARALLEL_TOL2 = 1e-12
_SIDE_EPS = 1e-6


def _corners(w, h, a):
    c2, s2 = torch.cos(a) * 0.5, torch.sin(a) * 0.5
    p0x, p0y = -s2 * h - c2 * w, c2 * h - s2 * w
    p1x, p1y = s2 * h - c2 * w, -c2 * h - s2 * w
    return torch.stack([p0x, p1x, -p0x, -p1x]), torch.stack([p0y, p1y, -p0y, -p1y])


def _clip_pass(pts_p, vec_p, pts_q, vec_q, eps):
    px, py = (a[:, None] for a in pts_p)
    dx, dy = (a[:, None] for a in vec_p)
    qx, qy = (a[None, :] for a in pts_q)
    ex, ey = (a[None, :] for a in vec_q)
    d2 = dx * dx + dy * dy
    c1 = ex * dy - ey * dx
    tie = torch.where(ex * dx + ey * dy > 0, eps, -_SIDE_EPS)
    c0 = ex * (py - qy) - ey * (px - qx) + tie
    para = c1 * c1 <= _PARALLEL_TOL2 * (ex * ex + ey * ey) * d2
    t = -c0 / torch.where(para, 1.0, c1)
    lo = torch.where(~para & (c1 > 0), t, 0.0).amax(1).clamp_min(0.0)
    hi = torch.where(~para & (c1 < 0), t, 1.0).amin(1).clamp_max(1.0)
    ok = (~para | (c0 >= 0)).all(1)
    dt = torch.where(ok, (hi - lo).clamp_min(0.0), 0.0)
    contrib = dt * (pts_p[0] * vec_p[1] - pts_p[1] * vec_p[0])
    return contrib.sum(0)


def iou_pairs(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Rotated IoU of broadcast ``[..., 5]`` boxes, float32."""
    x1, y1, w1, h1, a1 = b1.float().unbind(-1)
    x2, y2, w2, h2, a2 = b2.float().unbind(-1)
    sx, sy = (x1 - x2) * 0.5, (y1 - y2) * 0.5
    cax, cay = _corners(w1, h1, a1)
    cbx, cby = _corners(w2, h2, a2)
    pa = (cax + sx, cay + sy)
    pb = (cbx - sx, cby - sy)
    va = tuple(torch.roll(p, -1, 0) - p for p in pa)
    vb = tuple(torch.roll(p, -1, 0) - p for p in pb)
    inter = 0.5 * (_clip_pass(pa, va, pb, vb, _SIDE_EPS)
                   + _clip_pass(pb, vb, pa, va, -_SIDE_EPS)).abs()
    area1, area2 = w1 * h1, w2 * h2
    union = area1 + area2 - inter
    iou = inter / torch.where(union > 0, union, 1.0)
    return torch.where((area1 < 1e-14) | (area2 < 1e-14), 0.0, iou)


def box_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``[B, N, 5] x [B, M, 5] -> [B, N, M]``, in row blocks of about 4M
    pairs (each pair holds 16 edge-against-edge terms while it runs)."""
    if b1.shape[1] == 0 or b2.shape[1] == 0:
        return torch.zeros(b2.shape[0], b1.shape[1], b2.shape[1], device=b2.device)
    block = max(1, (1 << 22) // (b2.shape[0] * b2.shape[1]))
    return torch.cat([iou_pairs(blk[:, :, None], b2[:, None]) for blk in b1.split(block, 1)], 1)
