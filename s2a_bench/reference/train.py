"""The reference's loss and optimizer steps, plain float32 PyTorch.

The S2ANet loss as published: max-IoU assignment of rotated anchors
(positive at IoU >= 0.5, negative below 0.4, every gt claiming its best
anchors), sigmoid focal loss (gamma 2, alpha 0.5) and smooth L1 (beta
1/9) on the delta coding, FAM against the initial anchors and ODM against
the refined ones, each sum divided by the batch's positives (at least the
batch size). The update is SGD with momentum 0.9 after clipping the
gradient to a global norm of 35, weight decay on the kernels only, and a
linear warm-up of the rate.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .geometry import box_iou, rboxes_encode


def valid_anchors(anchors, hw):
    h, w = hw
    x, y, aw, ah = anchors[..., 0], anchors[..., 1], anchors[..., 2], anchors[..., 3]
    return (x >= 0) & (y >= 0) & (x <= w) & (y <= h) & (aw < w) & (ah < h)


def assign(anchors, gt_boxes, gt_mask, hw):
    """Codes ``[B, A]``: gt index, -1 negative, -2 ignored. Each image's
    IoUs are taken against its real rows only (padding never wins)."""
    b, g = gt_mask.shape
    iou = torch.full((b, anchors.shape[-2], g), -2.0, device=gt_boxes.device)
    for j in range(b):
        n = int(gt_mask[j].sum())
        if n:
            a = anchors[j] if anchors.dim() == 3 else anchors
            iou[j, :, :n] = box_iou(a[None], gt_boxes[j:j + 1, :n])[0]
    iou = torch.where((iou < 0) | (iou > 1), -0.5, iou)
    valid = valid_anchors(anchors, hw)
    iou = torch.where(valid[..., :, None], iou, -0.5)
    gm = gt_mask[:, None, :]
    iou = torch.where(gm, iou, -2.0)
    max_iou, argmax = iou.max(-1)
    codes = torch.where((max_iou >= 0) & (max_iou < 0.4), -1, -2)
    codes = torch.where(max_iou >= 0.5, argmax, codes)
    gt_best = iou.amax(-2, keepdim=True)
    claims = gm & (iou >= gt_best - 1e-6) & (gt_best > 0)
    ids = torch.arange(iou.shape[-1], device=iou.device)
    last = torch.where(claims, ids, -1).amax(-1)
    codes = torch.where(last >= 0, last, codes)
    no_gt = ~gt_mask.any(-1, keepdim=True)
    return torch.where(no_gt, torch.where(valid, -1, -2), codes)


def focal(logits, targets, gamma, alpha):
    bce = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    return bce * (targets * alpha + (1 - targets) * (1 - alpha)) * (1 - p_t) ** gamma


def smooth_l1(pred, target, beta):
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).sum(-1)


def _level(bbox, cls, anchors, codes, gt_boxes, gt_classes, nc, mc):
    pos, neg = codes >= 0, codes == -1
    idx = codes.clamp_min(0)
    boxes = torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, 5))
    labels = torch.gather(gt_classes, 1, idx)
    boxes = torch.where(pos[..., None], boxes, anchors)
    reg = (smooth_l1(bbox, rboxes_encode(anchors, boxes), mc["smooth_beta"]) * pos).sum()
    targets = F.one_hot(labels, nc).float() * pos[..., None]
    c = focal(cls, targets, mc["fl_gamma"], mc["fl_alpha"])
    return (c * (pos | neg).float()[..., None]).sum(), reg


def loss(out, gt_boxes, gt_classes, gt_mask, hw, mc):
    """``(total, items [4])``: fam_cls, fam_reg, odm_cls, odm_reg."""
    b = gt_boxes.shape[0]
    nc = mc["num_classes"]
    init = torch.cat(out["anchors"], 0)
    refine = torch.cat(out["refine"], 1).detach()
    fam_codes = assign(init, gt_boxes, gt_mask, hw)
    odm_codes = assign(refine, gt_boxes, gt_mask, hw)
    fam_pos = (fam_codes >= 0).sum().clamp_min(b).float()
    odm_pos = (odm_codes >= 0).sum().clamp_min(b).float()
    sums = [0.0] * 4
    start = 0
    for lvl, anchors in enumerate(out["anchors"]):
        n = anchors.shape[0]
        sl = slice(start, start + n)
        start += n
        wgt = mc["fpn_balance"][lvl]
        c, r = _level(out["fam_bbox"][lvl].reshape(b, n, 5), out["fam_cls"][lvl].reshape(b, n, nc),
                      anchors[None].expand(b, n, 5), fam_codes[:, sl], gt_boxes, gt_classes, nc, mc)
        sums[0], sums[1] = sums[0] + wgt * c, sums[1] + wgt * r
        c, r = _level(out["odm_bbox"][lvl].reshape(b, n, 5), out["odm_cls"][lvl].reshape(b, n, nc),
                      refine[:, sl], odm_codes[:, sl], gt_boxes, gt_classes, nc, mc)
        sums[2], sums[3] = sums[2] + wgt * c, sums[3] + wgt * r
    items = torch.stack([sums[0] / fam_pos, sums[1] / fam_pos * mc["reg_balance"],
                         sums[2] / odm_pos * mc["odm_balance"],
                         sums[3] / odm_pos * mc["odm_balance"] * mc["reg_balance"]])
    return items.sum(), items


def warmup_lr(tc: dict, step: int) -> float:
    """The rate of update ``step`` (0-based) inside the linear warm-up."""
    if step >= tc["warmup_iters"]:
        raise ValueError("the reference follows the warm-up only")
    f = tc["warmup_init_factor"]
    return tc["lr0"] * (f + (1 - f) * step / tc["warmup_iters"])


def sgd_steps(model, batches, mc: dict, tc: dict):
    """Train ``model`` (float32, train mode) on ``batches`` (dicts of
    ``imgs [B, 3, H, W]`` float32, ``gt_boxes``, ``gt_classes``,
    ``gt_mask``), one update each. Returns ``(items [steps, 4], first
    [leaves]: the norm of each leaf's first update direction, the clipped
    and decayed gradient that momentum starts from, first_grad [leaves]:
    its raw gradient's norm, change [leaves]: the norm of each leaf's move
    over all the steps)."""
    params = [p for p in model.parameters() if p.requires_grad]
    start = [p.detach().clone() for p in params]
    bufs = None
    items_all, first, first_grad = [], None, None
    for step, batch in enumerate(batches):
        out = model(batch["imgs"], with_fam_cls=True)
        total, items = loss(out, batch["gt_boxes"], batch["gt_classes"], batch["gt_mask"],
                            tuple(batch["imgs"].shape[-2:]), mc)
        grads = torch.autograd.grad(total, params)
        items_all.append(items.detach())
        if first_grad is None:
            first_grad = torch.stack([g.norm() for g in grads])
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = min(1.0, tc["grad_clip_norm"] / float(norm)) if tc["grad_clip_norm"] > 0 else 1.0
            d = [g * scale + (tc["weight_decay"] * p if p.dim() > 1 else 0)
                 for g, p in zip(grads, params)]
            bufs = d if bufs is None else [tc["momentum"] * m + g for m, g in zip(bufs, d)]
            if first is None:
                first = torch.stack([m.norm() for m in bufs])
            lr = warmup_lr(tc, step)
            for p, m in zip(params, bufs):
                p.sub_(lr * m)
    change = torch.stack([(p.detach() - s).norm() for p, s in zip(params, start)])
    return torch.stack(items_all), first, first_grad, change


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each leaf's gap between two vectors of per-leaf norms, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; NaN for the leaves not in ``keep``."""
    ref, prog = ref.double(), prog.double()
    med = ref[keep].median()
    gap = (prog - ref).abs() / torch.maximum(ref, med)
    return torch.where(keep, gap, math.nan)
