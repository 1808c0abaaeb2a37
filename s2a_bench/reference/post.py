"""The reference's decode and multiclass rotated NMS, plain float32 PyTorch.

As published for S2ANet serving: sigmoid scores of the ODM head; per
level the ``max_before_nms_per_level`` anchors of highest best-class score;
boxes decoded against the refined anchors; the ``pre_nms_cap`` (anchor,
class) pairs of highest score above ``score_thr`` are the candidates
(ties: the lower index first); greedy NMS per class (a candidate is
removed by an earlier kept one of its class with IoU above ``nms_iou_thr``);
the first ``max_per_img`` survivors.
"""

from __future__ import annotations

import torch

from .geometry import box_iou, rboxes_decode


def top_k(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def level_scores(out):
    """Per-level ``(scores [B, n, C], boxes [B, n, 5])`` of every anchor."""
    res = []
    for cls, bbox, anc in zip(out["odm_cls"], out["odm_bbox"], out["refine"]):
        b = cls.shape[0]
        scores = torch.sigmoid(cls.reshape(b, -1, cls.shape[-1]))
        res.append((scores, rboxes_decode(anc, bbox.reshape(b, -1, 5))))
    return res


def candidates(levels, mc: dict, score_thr: float):
    """``(scores [B, K], boxes [B, K, 5], labels [B, K], valid [B, K])``."""
    sc, bx = [], []
    for scores, boxes in levels:
        k = mc["max_before_nms_per_level"]
        if 0 < k < scores.shape[1]:
            _, idx = top_k(scores.amax(-1), k)
            scores = torch.gather(scores, 1, idx[..., None].expand(-1, -1, scores.shape[-1]))
            boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 5))
        sc.append(scores)
        bx.append(boxes)
    scores, boxes = torch.cat(sc, 1), torch.cat(bx, 1)
    b, n, c = scores.shape
    flat = scores.reshape(b, n * c)
    flat = torch.where(flat > score_thr, flat, -1.0)
    top, idx = top_k(flat, min(mc["pre_nms_cap"], n * c))
    cand = torch.gather(boxes, 1, (idx // c)[..., None].expand(-1, -1, 5))
    return top, cand, idx % c, top > score_thr


def nms(boxes, labels, valid, iou_thr: float):
    """Greedy keep ``[B, K]`` over score-sorted candidates."""
    alive = valid.clone()
    n = int((valid * torch.arange(1, valid.shape[1] + 1, device=valid.device)).amax()) \
        if valid.numel() else 0
    if n == 0:
        return alive
    over = box_iou(boxes[:, :n], boxes[:, :n]) > iou_thr
    over &= labels[:, :n, None] == labels[:, None, :n]
    over &= valid[:, :n, None] & valid[:, None, :n]
    over &= torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    a = alive[:, :n].clone()
    for i in range(n):
        a &= ~(over[:, i] & a[:, i:i + 1])
    alive[:, :n] = a
    return alive


def detections(levels, mc: dict, score_thr: float):
    """``(boxes [B, K, 5], scores [B, K], labels [B, K], keep [B, K])``:
    the candidates and which of them survive (at most ``max_per_img``)."""
    top, cand, labels, valid = candidates(levels, mc, score_thr)
    keep = nms(cand, labels, valid, mc["nms_iou_thr"]) & valid
    keep &= keep.cumsum(1) <= mc["max_per_img"]
    return cand, top, labels, keep
