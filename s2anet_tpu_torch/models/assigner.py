"""Max-IoU label assignment of rotated anchors, batched and masked.

Counterpart of ``s2anet_tpu/models/assigner.py`` (``assign_labels``,
``assign_from_iou``), with the same rules:

* positive at IoU >= 0.5 (the gt of highest IoU, the first on a tie),
  negative in [0, 0.4), ignore otherwise;
* anchors whose centre leaves the image or whose w/h reach its size are
  invalid -> ignore;
* IoUs outside [0, 1] are taken as broken and set to -0.5 -> ignore;
* padded gt columns sit at -2, so they never win and never make a negative;
* every real gt claims each anchor within 1e-6 of its best IoU (best > 0);
  on a conflict the last claiming gt wins;
* an image without gts makes every valid anchor negative.

Codes: >= 0 gt index, -1 negative, -2 ignore. The IoU comes from
:func:`..ops.iou_rotated.box_iou_rotated`, the CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..ops.iou_rotated import box_iou_rotated


def assign_from_iou(iou: torch.Tensor, valid: torch.Tensor, gt_mask: torch.Tensor,
                    pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                    min_pos_iou_thr: float = 0.0,
                    filter_invalid_ious: bool = True) -> torch.Tensor:
    """Assignment codes ``[..., A]`` int32 from ``iou [..., A, G]``,
    ``valid [..., A]`` and ``gt_mask [..., G]`` (leading axes batch)."""
    if filter_invalid_ious:
        iou = torch.where((iou < 0) | (iou > 1), -0.5, iou)
    iou = torch.where(valid[..., :, None], iou, -0.5)
    gm = gt_mask[..., None, :]
    iou = torch.where(gm, iou, -2.0)

    max_iou, argmax = iou.max(-1)
    minus2 = torch.full_like(argmax, -2)
    assign = torch.where((max_iou >= 0) & (max_iou < neg_iou_thr),
                         torch.full_like(argmax, -1), minus2)
    assign = torch.where(max_iou >= pos_iou_thr, argmax, assign)

    gt_best = iou.amax(-2, keepdim=True)  # [..., 1, G]
    claims = gm & (iou >= gt_best - 1e-6) & (gt_best > min_pos_iou_thr)
    gt_ids = torch.arange(iou.shape[-1], device=iou.device)
    fb = torch.where(claims, gt_ids, -1).amax(-1)  # last claiming gt
    assign = torch.where(fb >= 0, fb, assign)

    none_gt = ~gt_mask.any(-1, keepdim=True)
    no_gt_codes = torch.where(valid, -1, -2).to(assign.dtype)
    assign = torch.where(none_gt, no_gt_codes, assign)
    return assign.int()


def valid_anchors(anchors: torch.Tensor, imgs_size) -> torch.Tensor:
    """``[..., A]`` bool: centre inside the image, w and h below its size."""
    img_h, img_w = imgs_size
    x, y, w, h = anchors[..., 0], anchors[..., 1], anchors[..., 2], anchors[..., 3]
    return (x >= 0) & (y >= 0) & (x <= img_w) & (y <= img_h) \
        & (w < img_w) & (h < img_h)


def assign_labels(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_mask: torch.Tensor, imgs_size=(1024, 1024)) -> torch.Tensor:
    """Codes ``[B, A]`` for ``anchors [A, 5]`` (shared by the batch) or
    ``[B, A, 5]``, against ``gt_boxes [B, G, 5]`` with ``gt_mask [B, G]``.

    One rotated-IoU call for the batch (one kernel launch on the card).
    """
    iou = box_iou_rotated(anchors, gt_boxes)
    return assign_from_iou(iou, valid_anchors(anchors, imgs_size), gt_mask)
