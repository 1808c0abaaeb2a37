"""Pairwise rotated-box IoU.

Counterpart of ``s2anet_tpu/ops/iou_rotated.py`` (``iou_pairs``, the plain
version here) and of the TPU kernel
``s2anet_tpu/ops/pallas/iou_kernel.py::_kernel`` (``box_iou_rotated_pallas``),
whose port is ``csrc/iou_nms_rotated.cu``.

The intersection area is a sort-free boundary tally: the boundary of A n B
is made of the pieces of A's edges inside B and of B's edges inside A, and
the shoelace sum over directed edges does not depend on their order, so

    2 * area(A n B) = sum over the 8 edges of (t1 - t0) * cross(p, d)

with ``[t0, t1]`` the parametric interval of edge ``p + t*d`` inside the
other box. Shared and collinear edges are broken by an orientation-aware
epsilon on exactly-zero crosses (see the JAX module for the derivation).
"""

from __future__ import annotations

import torch

from .._ext import I, P, Kernel

_PARALLEL_TOL2 = 1e-12  # relative (cos angle)^2 cutoff for parallel edges
_SIDE_EPS = 1e-6        # half-plane tie-break; acts only on exact-zero crosses

BOX_IOU = Kernel("iou_nms_rotated", "s2a_box_iou_rotated", [P, P, P, I, I, I, I, P])


def _corners_centered(w, h, a):
    """``(px, py)``, each ``[4, *shape]``: corners of a centred rotated rect,
    traced so that the interior satisfies ``cross(edge, p - corner) >= 0``."""
    c2 = torch.cos(a) * 0.5
    s2 = torch.sin(a) * 0.5
    p0x = -s2 * h - c2 * w
    p0y = c2 * h - s2 * w
    p1x = s2 * h - c2 * w
    p1y = -c2 * h - s2 * w
    return (torch.stack([p0x, p1x, -p0x, -p1x]),
            torch.stack([p0y, p1y, -p0y, -p1y]))


def _clip_pass(pts_p, vec_p, pts_q, vec_q, eps):
    """Sum of cross(start, end) over the pieces of P's edges inside Q."""
    px, py = (a[:, None] for a in pts_p)
    dx, dy = (a[:, None] for a in vec_p)
    qx, qy = (a[None, :] for a in pts_q)
    ex, ey = (a[None, :] for a in vec_q)
    d2 = dx * dx + dy * dy
    c1 = ex * dy - ey * dx
    # opposite-direction collinear twins -> always-drop bias
    tie = torch.where(ex * dx + ey * dy > 0, eps, -_SIDE_EPS)
    c0 = ex * (py - qy) - ey * (px - qx) + tie
    para = c1 * c1 <= _PARALLEL_TOL2 * (ex * ex + ey * ey) * d2
    t = -c0 / torch.where(para, 1.0, c1)
    lo = torch.where(~para & (c1 > 0), t, 0.0).amax(1).clamp_min(0.0)
    hi = torch.where(~para & (c1 < 0), t, 1.0).amin(1).clamp_max(1.0)
    ok = (~para | (c0 >= 0)).all(1)
    dt = torch.where(ok, (hi - lo).clamp_min(0.0), 0.0)
    contrib = dt * (pts_p[0] * vec_p[1] - pts_p[1] * vec_p[0])
    return contrib[0] + contrib[1] + contrib[2] + contrib[3]


def iou_pairs(params1, params2):
    """Elementwise rotated IoU over broadcast ``(x, y, w, h, theta)`` tuples
    of float32 tensors; returns the broadcast shape."""
    x1, y1, w1, h1, a1 = params1
    x2, y2, w2, h2, a2 = params2
    # pair-midpoint centering: exact zeros for identical boxes
    sx = (x1 - x2) * 0.5
    sy = (y1 - y2) * 0.5
    cax, cay = _corners_centered(w1, h1, a1)
    cbx, cby = _corners_centered(w2, h2, a2)
    pa = (cax + sx, cay + sy)
    pb = (cbx - sx, cby - sy)
    va = tuple(torch.roll(p, -1, 0) - p for p in pa)
    vb = tuple(torch.roll(p, -1, 0) - p for p in pb)
    acc = _clip_pass(pa, va, pb, vb, _SIDE_EPS) + _clip_pass(
        pb, vb, pa, va, -_SIDE_EPS)
    inter = 0.5 * acc.abs()
    area1 = w1 * h1
    area2 = w2 * h2
    union = area1 + area2 - inter
    iou = inter / torch.where(union > 0, union, 1.0)
    return torch.where((area1 < 1e-14) | (area2 < 1e-14), 0.0, iou)


def _as_batch(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """``(b1 [1 or B, N, 5], b2 [B, M, 5], batched)`` from ``[N, 5] x [M, 5]``
    (unbatched, B = 1) or ``[N, 5] or [B, N, 5] x [B, M, 5]``; a ``[N, 5]``
    boxes1 against a batch is shared by every image."""
    batched = boxes2.dim() == 3
    b1 = boxes1 if boxes1.dim() == 3 else boxes1[None]
    b2 = boxes2 if batched else boxes2[None]
    if (boxes1.dim() not in (2, 3) or boxes2.dim() not in (2, 3) or b1.shape[-1] != 5
            or b2.shape[-1] != 5 or (not batched and boxes1.dim() == 3)
            or b1.shape[0] not in (1, b2.shape[0])):
        raise ValueError("boxes are [N, 5] x [M, 5], or [N, 5] or [B, N, 5] x [B, M, 5]")
    return b1, b2, batched


def box_iou_rotated_plain(boxes1: torch.Tensor, boxes2: torch.Tensor,
                          block_n: int = 256) -> torch.Tensor:
    """``[N, 5] x [M, 5] -> [N, M]``, or ``[N, 5] or [B, N, 5] x [B, M, 5]
    -> [B, N, M]``, float32, in row blocks of ``block_n``."""
    b1, b2, batched = _as_batch(boxes1.float(), boxes2.float())
    p2 = tuple(b2[:, None, :, k] for k in range(5))
    rows = [iou_pairs(tuple(blk[:, :, None, k] for k in range(5)), p2)
            for blk in b1.split(block_n, dim=1)]
    if rows:
        out = torch.cat(rows, 1)
    else:
        out = torch.zeros(b2.shape[0], 0, b2.shape[1], device=b1.device)
    return out if batched else out[0]


def box_iou_rotated_cuda(boxes1: torch.Tensor,
                         boxes2: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (``csrc/iou_nms_rotated.cu``) on CUDA tensors: one
    launch for the batch; shared ``[N, 5]`` boxes1 are read with a batch
    stride of 0, not copied."""
    if not (boxes1.is_cuda and boxes2.is_cuda):
        raise ValueError("box_iou_rotated_cuda takes CUDA tensors")
    b1, b2, batched = _as_batch(boxes1.float().contiguous(),
                                boxes2.float().contiguous())
    b, n, m = b2.shape[0], b1.shape[1], b2.shape[1]
    out = torch.empty(b, n, m, dtype=torch.float32, device=b1.device)
    BOX_IOU(b1.data_ptr(), b2.data_ptr(), out.data_ptr(), b, n, m,
            int(b1.shape[0] == 1), torch.cuda.current_stream(b1.device).cuda_stream)
    return out if batched else out[0]


def box_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated IoU, ``[N, M]`` or batched ``[B, N, M]`` (shapes as
    in :func:`box_iou_rotated_plain`): the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors. The kernel also returns 0 for pairs
    whose bounding circles are apart."""
    if boxes1.device.type == "cpu":
        return box_iou_rotated_plain(boxes1, boxes2)
    return box_iou_rotated_cuda(boxes1, boxes2)
