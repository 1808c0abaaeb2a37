"""The comparisons that decide ``correct``: what the timed path produced,
judged by the plain reference on the same weights and inputs.

Serving (:func:`serve_readings`): the served detections of each image are
matched 1:1 to the reference's own detections (its decode + NMS): same
class, rotated IoU at least 0.5, the pairs of highest IoU first. A served
detection left without a partner is paired with the reference's NMS
candidate of its class that overlaps it most (IoU at least 0.5), so that
every served score is judged. A pair at IoU 0.9 or more is a twin: the
same anchor on both sides (neighbouring anchors overlap by about 0.6),
so its logits differ by arithmetic alone.

* ``unmatched``: the share of served and reference detections, over the
  sampled images, left without a 1:1 partner;
* ``twin_gap``: the mean gap between the class logits of a twin pair;
* ``nms_overlap``: the largest rotated IoU between two served detections
  of one class (greedy NMS leaves none above the configuration's
  ``nms_iou_thr``).

Also read, not compared: ``twin_gap_max``, the widest twin gap (one sound
float32 seed in 35 read it above the TF32 control's, PERF.md);
``logit_gap`` and ``logit_gap_max`` over every pair, twins or not (a
pair of neighbours, where NMS kept one anchor on one side and its
neighbour on the other, differs by the neighbours' logits); and
``count_gap``, the widest relative gap between an image's number of
served detections and the reference's.

Training (:func:`train_readings`), over the first three steps:

* ``loss_gap``: the widest relative gap of a loss item;
* ``grad_gap``: the median leaf's gap of the first update direction's
  norm (the clipped, decayed gradient momentum starts from), against the
  reference's norm of that leaf or of the median leaf, whichever is larger;
* ``step_gap``: the median leaf's gap of the norm of the parameters' move
  over the three steps, measured so;
* ``grad_gap_worst``, ``step_gap_worst``: the same gaps of the worst leaf.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out (they move by round-off alone).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import geometry, model as ref_model, post, train as ref_train

INV255 = float(np.float32(1.0 / 255.0))
MATCH_IOU, TWIN_IOU = 0.5, 0.9


def as_input(u8: torch.Tensor) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> float32 ``[B, 3, H, W]`` times float32(1/255)."""
    return (u8.float() * INV255).permute(0, 3, 1, 2).contiguous()


def reference_model(cfg: dict, state_dict: dict, device, train: bool, precision="fp32"):
    ref_model.plain_math()
    net = ref_model.from_config(cfg["model"]).to(device)
    net.load_state_dict(state_dict)
    net.set_precision(precision)
    return net.train(train)


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double().clamp(1e-300, 1 - 1e-16)
    return torch.log(p) - torch.log1p(-p)


def reference_detections(cfg: dict, state_dict: dict, images: torch.Tensor, score_thr: float,
                         device, chunk: int = 4):
    """The reference's NMS candidates of ``images [n, H, W, 3]`` uint8
    and which of them it keeps: ``(boxes [n, K, 5], scores [n, K], labels
    [n, K], valid [n, K], keep [n, K])``."""
    net = reference_model(cfg, state_dict, device, train=False)
    outs = []
    with torch.no_grad():
        for i0 in range(0, images.shape[0], chunk):
            out = net(as_input(images[i0:i0 + chunk].to(device)))
            top, cand, labels, valid = post.candidates(post.level_scores(out), cfg["model"],
                                                       score_thr)
            keep = post.nms(cand, labels, valid, cfg["model"]["nms_iou_thr"]) & valid
            keep &= keep.cumsum(1) <= cfg["model"]["max_per_img"]
            outs.append((cand, top, labels, valid, keep))
    return [torch.cat(t) for t in zip(*outs)]


def serve_readings(cfg: dict, state_dict: dict, images: torch.Tensor, served: list,
                   score_thr: float, device, chunk: int = 4) -> dict:
    """``images [n, H, W, 3]`` uint8 (host); ``served`` the program's
    ``(det_boxes [n, K, 6], det_labels [n, K], det_valid [n, K])`` as NumPy."""
    n_cls = cfg["model"]["num_classes"]
    r_boxes, r_scores, r_labels, r_valid, r_keep = reference_detections(
        cfg, state_dict, images, score_thr, device, chunk)
    boxes_p = torch.from_numpy(np.asarray(served[0])).to(device).double()
    labels_p = torch.from_numpy(np.asarray(served[1])).to(device).long()
    valid_p = torch.from_numpy(np.asarray(served[2])).to(device).bool()
    out = {"unmatched": 0.0, "twin_gap": 0.0, "twin_gap_max": 0.0, "nms_overlap": 0.0,
           "logit_gap": 0.0, "logit_gap_max": 0.0, "count_gap": 0.0}
    gaps, ious, pairs, n_served, n_ref, n_matched = [], [], [], 0, 0, 0
    for j in range(images.shape[0]):
        keep = r_keep[j]
        rb, rl, rs = r_boxes[j][keep].double(), r_labels[j][keep], r_scores[j][keep]
        v = valid_p[j]
        pb, pl = boxes_p[j][v], labels_p[j][v]
        out["count_gap"] = max(out["count_gap"], abs(len(pb) - len(rb)) / max(len(rb), 1))
        n_served, n_ref = n_served + len(pb), n_ref + len(rb)
        if len(pb) == 0:
            continue
        if bool((pl < 0).any() or (pl >= n_cls).any()) or not bool(torch.isfinite(pb).all()):
            return {k: math.inf for k in out}
        i, k, iou = match_1to1(pb[:, :5], pl, rb, rl)
        n_matched += len(i)
        gaps.append((_logit(pb[i, 5]) - _logit(rs[k])).abs())
        ious.append(iou)
        pairs.append((j, pb[i], rb[k], rs[k]))
        # the rest against the candidate of their class that overlaps them most
        rest = torch.ones(len(pb), dtype=torch.bool, device=pb.device)
        rest[i] = False
        if bool(rest.any()):
            cv = r_valid[j]
            u, c, iou = best_partner(pb[rest, :5], pl[rest], r_boxes[j][cv].double(),
                                     r_labels[j][cv])
            gaps.append((_logit(pb[rest][u, 5]) - _logit(r_scores[j][cv][c])).abs())
            ious.append(iou)
            pairs.append((j, pb[rest][u], r_boxes[j][cv][c].double(), r_scores[j][cv][c]))
        out["nms_overlap"] = max(out["nms_overlap"], _same_class_iou(pb[:, :5], pl))
    out["unmatched"] = (n_served + n_ref - 2 * n_matched) / max(n_served + n_ref, 1)
    if gaps:
        gaps, ious = torch.cat(gaps), torch.cat(ious).to(device)
        twin = gaps[ious >= TWIN_IOU]
        out.update(logit_gap=float(gaps.mean()), logit_gap_max=float(gaps.max()))
        if len(twin):
            out.update(twin_gap=float(twin.mean()), twin_gap_max=float(twin.max()))
            w = int(torch.where(ious >= TWIN_IOU, gaps, -1.0).argmax())
            out["worst_twin"] = _pair_record(pairs, w, float(ious[w]))
        out.update(compared=len(gaps), twins=len(twin))
    out.update(served=n_served, matched=n_matched)
    return out


def _pair_record(pairs, w: int, iou: float) -> dict:
    """The ``w``-th compared pair, for the record: its image, the served
    box and score, the reference's box and score, their IoU."""
    for j, served, ref, ref_score in pairs:
        if w < len(served):
            return {"image": j, "served": served[w].tolist(),
                    "reference": ref[w].tolist() + [float(ref_score[w])], "iou": iou}
        w -= len(served)
    return {}


def overlapping_pairs(pb: torch.Tensor, pl: torch.Tensor, rb: torch.Tensor, rl: torch.Tensor,
                      block: int = 1 << 20):
    """The pairs ``(i into pb, k into rb, IoU)`` of the same label at
    rotated IoU >= ``MATCH_IOU``, the highest IoU first."""
    # pairs that can overlap: same label, centres within the half diagonals
    r1 = 0.5 * pb[:, 2:4].norm(dim=1)
    r2 = 0.5 * rb[:, 2:4].norm(dim=1)
    ii, kk = [], []
    for s in range(0, len(pb), 1024):
        d = torch.cdist(pb[s:s + 1024, :2], rb[:, :2])
        near = (d <= r1[s:s + 1024, None] + r2[None, :]) & (pl[s:s + 1024, None] == rl[None, :])
        a, b = near.nonzero(as_tuple=True)
        ii.append(a + s)
        kk.append(b)
    ii, kk = torch.cat(ii), torch.cat(kk)
    iou = torch.cat([geometry.iou_pairs(pb[ii[s:s + block]], rb[kk[s:s + block]])
                     for s in range(0, len(ii), block)]) if len(ii) else ii.float()
    ok = iou >= MATCH_IOU
    ii, kk, iou = ii[ok], kk[ok], iou[ok]
    order = torch.argsort(iou, descending=True, stable=True)
    return ii[order].cpu().numpy(), kk[order].cpu().numpy(), iou[order].cpu()


def match_1to1(pb: torch.Tensor, pl: torch.Tensor, rb: torch.Tensor, rl: torch.Tensor):
    """Greedy 1:1 matches of boxes ``pb`` to ``rb`` of the same label at
    rotated IoU >= ``MATCH_IOU``, the pairs of highest IoU first. Returns
    the matched indices ``(i into pb, k into rb)`` and their IoUs."""
    empty = torch.zeros(0, dtype=torch.long, device=pb.device)
    if len(pb) == 0 or len(rb) == 0:
        return empty, empty, empty.float()
    ii, kk, iou = overlapping_pairs(pb, pl, rb, rl)
    used_p = np.zeros(len(pb), bool)
    used_r = np.zeros(len(rb), bool)
    taken = []
    for n, (a, b) in enumerate(zip(ii.tolist(), kk.tolist())):
        if not used_p[a] and not used_r[b]:
            used_p[a] = used_r[b] = True
            taken.append(n)
    taken = torch.tensor(taken, dtype=torch.long)
    return (torch.from_numpy(ii)[taken].to(pb.device), torch.from_numpy(kk)[taken].to(pb.device),
            iou[taken].to(pb.device))


def best_partner(pb: torch.Tensor, pl: torch.Tensor, rb: torch.Tensor, rl: torch.Tensor):
    """For each box of ``pb`` that has one, the box of ``rb`` of its label
    that overlaps it most (IoU >= ``MATCH_IOU``): ``(i into pb, k into rb,
    IoU)``."""
    empty = torch.zeros(0, dtype=torch.long, device=pb.device)
    if len(pb) == 0 or len(rb) == 0:
        return empty, empty, empty.float()
    ii, kk, iou = overlapping_pairs(pb, pl, rb, rl)
    _, first = np.unique(ii, return_index=True)  # pairs come highest IoU first
    first = torch.from_numpy(first)
    return (torch.from_numpy(ii)[first].to(pb.device), torch.from_numpy(kk)[first].to(pb.device),
            iou[first].to(pb.device))


def _same_class_iou(boxes: torch.Tensor, labels: torch.Tensor) -> float:
    worst = 0.0
    for c in labels.unique():
        b = boxes[labels == c].float()
        if len(b) < 2:
            continue
        iou = geometry.box_iou(b[None], b[None])[0]
        iou = iou.triu(1)
        worst = max(worst, float(iou.max()))
    return worst


def reference_candidates(cfg: dict, state_dict: dict, images: torch.Tensor, score_thr: float,
                         device, chunk: int = 4):
    """The reference's NMS candidates of ``images`` (for the NMS's work)."""
    net = reference_model(cfg, state_dict, device, train=False)
    outs = []
    with torch.no_grad():
        for i0 in range(0, images.shape[0], chunk):
            out = net(as_input(images[i0:i0 + chunk].to(device)))
            _, cand, labels, valid = post.candidates(post.level_scores(out), cfg["model"], score_thr)
            outs.append((cand, labels, valid))
    return [torch.cat(t) for t in zip(*outs)]


def train_readings(cfg: dict, state_dict: dict, batches: list, prog: dict, device) -> dict:
    """``batches``: the first three steps' host batches (``imgs`` uint8 ``[B,
    H, W, 3]`` tensor, ``gt_boxes``, ``gt_classes``, ``gt_mask`` NumPy);
    ``prog``: the program's ``items [3, 4]``, and per parameter name its
    first update direction's norm (``first``) and its move's (``change``)."""
    net = reference_model(cfg, state_dict, device, train=True)
    dev_batches = [{"imgs": as_input(b["imgs"].to(device)),
                    "gt_boxes": torch.from_numpy(np.asarray(b["gt_boxes"], np.float32)).to(device),
                    "gt_classes": torch.from_numpy(np.asarray(b["gt_classes"], np.int64)).to(device),
                    "gt_mask": torch.from_numpy(np.asarray(b["gt_mask"], bool)).to(device)}
                   for b in batches]
    items, first, first_grad, change = ref_train.sgd_steps(net, dev_batches, cfg["model"],
                                                          cfg["train"])
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    keep = first_grad >= 1e-3 * first_grad.median()
    p_items = torch.as_tensor(np.asarray(prog["items"]), dtype=torch.float64)
    r_items = items.double().cpu()
    loss_gap = float(((p_items - r_items).abs() / r_items.abs().clamp_min(1e-12)).max())
    p_first = torch.tensor([prog["first"].get(n, math.nan) for n in names], dtype=torch.float64)
    p_change = torch.tensor([prog["change"].get(n, math.nan) for n in names], dtype=torch.float64)
    keep = keep.cpu()
    g_first = ref_train.leaf_gaps(p_first, first.cpu(), keep)
    g_change = ref_train.leaf_gaps(p_change, change.cpu(), keep)
    out = {"loss_gap": loss_gap}
    for key, g in (("grad_gap", g_first), ("step_gap", g_change)):
        g = torch.where(torch.isnan(g) & keep, math.inf, g)  # a leaf the program lacks
        worst = int(torch.nan_to_num(g, nan=-1.0).argmax())
        out[key] = float(g[keep].median()) if bool(keep.any()) else math.nan
        out[key + "_worst"] = float(g[worst])
        out[key + "_worst_leaf"] = names[worst]
    out.update(leaves_compared=int(keep.sum()), leaves=len(names))
    return out
