"""Rotated NMS: multiclass with fixed-capacity outputs, batched over images,
and the single-image entry points :func:`nms_rotated` / :func:`ml_nms_rotated`.

Counterpart of ``s2anet_tpu/ops/nms_rotated.py::multiclass_nms_rotated``:
scores at or below ``score_thr`` become -1, the top ``pre_nms_cap`` of the
flat ``N*C`` scores are the candidates (label = index mod C), boxes of
different labels never suppress each other, suppression is ``IoU > iou_thr``
(strict), invalid candidates never suppress, and the survivors' top
``max_per_img`` come out with a validity mask.

The greedy keep runs as two CUDA kernels on a CUDA tensor (the bitmask of
suppressing pairs, then a sweep per image; ``csrc/iou_nms_rotated.cu``) and
as a dense IoU matrix plus a sequential sweep on a CPU tensor, both through
the custom ops ``s2anet::s2a_nms_rotated_mask`` and
``s2anet::s2a_nms_rotated_sweep`` (``ops/library.py``).
"""

from __future__ import annotations

import torch

from .._ext import F, I, P, Kernel
from .iou_rotated import iou_pairs
from .topk import top_k

NMS_MASK = Kernel("iou_nms_rotated", "s2a_nms_rotated_mask",
                  [P, P, P, F, P, I, I, P])
NMS_SWEEP = Kernel("iou_nms_rotated", "s2a_nms_rotated_sweep",
                   [P, P, P, I, I, P])


def overlap_plain(boxes: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor, iou_thr: float, n: int,
                  block_n: int = 256) -> torch.Tensor:
    """``[B, n, n]`` bool over the first ``n`` candidates: row ``i``
    suppresses column ``j`` (j > i, both valid, equal labels, IoU > thr)."""
    bx = boxes[:, :n].float()
    lab = labels[:, :n]
    ok = valid[:, :n]
    cols = tuple(bx[:, None, :, c] for c in range(5))
    later = torch.ones(n, n, dtype=torch.bool, device=bx.device).triu(1)
    over = []
    for r0 in range(0, n, block_n):
        r1 = min(r0 + block_n, n)
        rows = tuple(bx[:, r0:r1, None, c] for c in range(5))
        o = iou_pairs(rows, cols) > iou_thr
        o &= lab[:, r0:r1, None] == lab[:, None, :]
        o &= ok[:, r0:r1, None] & ok[:, None, :]
        o &= later[r0:r1]
        over.append(o)
    return torch.cat(over, 1)


def nms_keep_plain(boxes: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """Greedy keep mask ``[B, K]`` of score-sorted candidates ``[B, K, 5]``:
    the dense overlap matrix, then a sequential sweep in which a suppressed
    row suppresses nothing."""
    alive = valid.clone()
    n = last_valid(valid)
    if n == 0:
        return alive
    over = overlap_plain(boxes, labels, valid, iou_thr, n)
    alive[:, :n] = sweep_plain(over, valid[:, :n])
    return alive


def last_valid(valid: torch.Tensor) -> int:
    """One past the last valid candidate of any image of ``valid [B, K]``
    (0 if none): score-sorted candidates put the valid ones first, so the
    plain NMS sweeps up to there."""
    pos = torch.arange(1, valid.shape[1] + 1, device=valid.device)
    return int((valid * pos).amax()) if valid.numel() else 0


def sweep_plain(over: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Greedy sweep over ``over [B, n, n]``: rows in order, each row still
    alive removes the columns it overlaps. Returns the survivors ``[B, n]``."""
    a = alive.clone()
    for i in range(a.shape[1]):
        a &= ~(over[:, i] & a[:, i:i + 1])
    return a


def _mask_inputs(boxes: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor):
    if not (boxes.is_cuda and labels.is_cuda and valid.is_cuda):
        raise ValueError("the NMS kernels take CUDA tensors")
    b, k = valid.shape
    if boxes.shape != (b, k, 5) or labels.shape != (b, k):
        raise ValueError("NMS kernels: boxes [B,K,5], labels/valid [B,K]")
    return (boxes.float().contiguous(), labels.to(torch.int32).contiguous(),
            valid.to(torch.bool).contiguous())


def _mask(bx, lab, ok, iou_thr: float, stream: int) -> torch.Tensor:
    b, k = ok.shape
    mask = torch.empty(b, k, (k + 63) // 64, dtype=torch.int64, device=bx.device)
    NMS_MASK(bx.data_ptr(), lab.data_ptr(), ok.data_ptr(), float(iou_thr),
             mask.data_ptr(), b, k, stream)
    return mask


def nms_mask_cuda(boxes: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """The suppression bitmask ``[B, K, ceil(K/64)]`` (int64 words; bit
    ``j % 64`` of word ``j // 64`` of row ``i`` as in :func:`overlap_plain`).
    Only the words of valid rows, from the row's own word on, are certain
    to be written: the sweep uses no other."""
    bx, lab, ok = _mask_inputs(boxes, labels, valid)
    return _mask(bx, lab, ok, iou_thr, torch.cuda.current_stream(bx.device).cuda_stream)


def nms_sweep_cuda(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The sweep kernel: the greedy keep ``[B, K]`` over the bitmask of
    :func:`nms_mask_cuda` and the valid flags."""
    b, k = valid.shape
    if not (mask.is_cuda and valid.is_cuda):
        raise ValueError("the NMS kernels take CUDA tensors")
    if mask.shape != (b, k, (k + 63) // 64) or mask.dtype != torch.int64:
        raise ValueError(f"NMS sweep: mask {tuple(mask.shape)} {mask.dtype}, want "
                         f"{(b, k, (k + 63) // 64)} int64")
    mask = mask.contiguous()
    ok = valid.to(torch.bool).contiguous()
    keep = torch.empty(b, k, dtype=torch.bool, device=mask.device)
    NMS_SWEEP(mask.data_ptr(), ok.data_ptr(), keep.data_ptr(), b, k,
              torch.cuda.current_stream(mask.device).cuda_stream)
    return keep


def nms_keep_cuda(boxes: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """The two CUDA kernels: suppression bitmask, then one sweep per image."""
    return nms_sweep_cuda(nms_mask_cuda(boxes, labels, valid, iou_thr), valid)


def nms_keep(boxes, labels, valid, iou_thr):
    """Greedy keep mask through the custom ops: the CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors (equal to
    :func:`nms_keep_plain` bit for bit)."""
    mask = torch.ops.s2anet.s2a_nms_rotated_mask(boxes, labels, valid, float(iou_thr))
    return torch.ops.s2anet.s2a_nms_rotated_sweep(mask, valid)


def ml_nms_rotated(boxes: torch.Tensor, scores: torch.Tensor, labels=None,
                   iou_thr: float = 0.5, valid=None) -> torch.Tensor:
    """Multi-label rotated NMS of one image (JAX ``ml_nms_rotated``): boxes
    ``[K, 5]``, scores ``[K]``, labels ``[K]`` (None: one label for all)
    and ``valid`` ``[K]`` bool (None: all). Invalid scores become -inf and
    the candidates are taken in the stable order of ``-score`` (JAX's
    ``argsort``; a tie keeps the lower index first); boxes of different
    labels never suppress each other and invalid ones never suppress.
    Returns the keep mask ``[K]`` in input order, through :func:`nms_keep`
    (the CUDA mask and sweep on a CUDA tensor)."""
    k = boxes.shape[0]
    if valid is None:
        valid = torch.ones(k, dtype=torch.bool, device=boxes.device)
    keep = torch.zeros(k, dtype=torch.bool, device=boxes.device)
    if k == 0:
        return keep
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(-s, stable=True)
    lab = (torch.zeros(k, dtype=torch.int64, device=boxes.device) if labels is None
           else labels[order])
    keep[order] = nms_keep(boxes[order][None], lab[None], valid[order][None], iou_thr)[0]
    return keep


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float = 0.5,
                valid=None) -> torch.Tensor:
    """Single-class rotated NMS (JAX ``nms_rotated``): :func:`ml_nms_rotated`
    with one label for all boxes; the keep mask ``[K]`` in input order."""
    return ml_nms_rotated(boxes, scores, None, iou_thr, valid)


def select_candidates(bboxes: torch.Tensor, scores: torch.Tensor,
                      score_thr: float, pre_nms_cap: int):
    """The NMS candidates: the top ``min(pre_nms_cap, N*C)`` (box, class)
    pairs by score, sorted (ties: the lower flat index first, as in
    ``lax.top_k``), scores at or below ``score_thr`` set to -1.

    Returns ``(scores [B,K], boxes [B,K,5], labels [B,K], valid [B,K])``.
    """
    b, n, c = scores.shape
    flat = scores.reshape(b, n * c)
    flat = torch.where(flat > score_thr, flat, -1.0)
    top_scores, top_idx = top_k(flat, min(pre_nms_cap, n * c))
    cand_boxes = torch.gather(bboxes, 1, (top_idx // c)[..., None].expand(-1, -1, 5))
    return top_scores, cand_boxes, top_idx % c, top_scores > score_thr


def multiclass_nms_rotated(bboxes: torch.Tensor, scores: torch.Tensor,
                           score_thr: float = 0.05, iou_thr: float = 0.5,
                           max_per_img: int = 2000, pre_nms_cap: int = 4096):
    """Per-image multiclass rotated NMS, batched.

    Args:
      bboxes: ``[B, N, 5]`` decoded boxes.
      scores: ``[B, N, C]`` per-class probabilities.

    Returns:
      ``det_boxes [B, max_per_img, 6]`` (x, y, w, h, theta, score),
      ``det_labels [B, max_per_img]`` int64, ``det_valid [B, max_per_img]``.
    """
    top_scores, cand_boxes, cand_labels, cand_valid = select_candidates(
        bboxes, scores, score_thr, pre_nms_cap)
    k = top_scores.shape[1]
    alive = nms_keep(cand_boxes, cand_labels, cand_valid, iou_thr) & cand_valid

    kept = torch.where(alive, top_scores, -1.0)
    m = min(max_per_img, k)
    # the survivors come out in candidate order, as lax.top_k gives them
    sel_scores, sel = top_k(kept, m)
    det_valid = sel_scores > score_thr
    det_boxes = torch.cat(
        [torch.gather(cand_boxes, 1, sel[..., None].expand(-1, -1, 5)),
         sel_scores.clamp_min(0.0)[..., None]], -1)
    det_labels = torch.gather(cand_labels, 1, sel)
    if max_per_img > k:  # pad up to the fixed output size
        pad = max_per_img - k
        det_boxes = torch.nn.functional.pad(det_boxes, (0, 0, 0, pad))
        det_labels = torch.nn.functional.pad(det_labels, (0, pad))
        det_valid = torch.nn.functional.pad(det_valid, (0, pad))
    return det_boxes, det_labels, det_valid
