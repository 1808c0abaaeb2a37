"""VOC-style mAP evaluation on rotated-box polygons.

A copy of ``s2anet_tpu/eval/voc_eval.py`` (the DOTA devkit's evaluator):

  * per class: detections pooled over images, sorted by confidence;
  * greedy TP matching at polygon IoU > ovthresh (0.5) with an
    axis-aligned prefilter, each gt matched at most once;
  * 'difficult' gt count neither as positives nor in npos;
  * AP by the 11-point VOC-07 metric (``use_07_metric``, the default) or
    the continuous VOC-10 one;
  * the max-F1 operating point (precision, recall, confidence) per class.

Polygon IoU is the double-precision oracle (:mod:`..ops.polyiou`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops.polyiou import iou_poly


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = True) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = float(np.max(prec[rec >= t])) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _poly_hbb(poly: np.ndarray):
    xs = poly[0::2]
    ys = poly[1::2]
    return xs.min(), ys.min(), xs.max(), ys.max()


def _hbb_iou(a, b) -> float:
    """Axis-aligned IoU of two (x1, y1, x2, y2) boxes (Task2 metric)."""
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(area_a + area_b - inter, 1e-12)


def voc_eval_class(
    detections: Sequence[Tuple[str, float, np.ndarray]],
    gt: Dict[str, List[Tuple[np.ndarray, bool]]],
    ovthresh: float = 0.5,
    use_07_metric: bool = True,
    task: int = 1,
):
    """Evaluate one class.

    Args:
      detections: iterable of (image_name, score, poly[8]).
      gt: {image_name: [(poly[8], difficult), ...]} — every eval image must
        have an entry (possibly empty).
      task: 1 = oriented (polygon IoU, dota_evaluation_task1.py), 2 =
        horizontal (polygons collapse to their axis-aligned boxes and IoU is
        plain HBB IoU, dota_evaluation_task2.py semantics).

    Returns:
      dict with rec, prec, ap, scores (sorted desc), npos, and the max-F1
      operating point (f1, precision, recall, conf).
    """
    class_gt = {}
    npos = 0
    for img, objs in gt.items():
        polys = [np.asarray(p, dtype=np.float64).reshape(8) for p, _ in objs]
        difficult = np.array([bool(d) for _, d in objs], dtype=bool)
        npos += int((~difficult).sum())
        class_gt[img] = {
            "polys": polys,
            "difficult": difficult,
            "matched": np.zeros(len(polys), bool),
            "hbb": [_poly_hbb(p) for p in polys],
        }

    dets = sorted(detections, key=lambda d: -d[1])
    nd = len(dets)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    scores = np.array([d[1] for d in dets])

    for i, (img, score, poly) in enumerate(dets):
        entry = class_gt.get(img)
        if entry is None or not entry["polys"]:
            fp[i] = 1
            continue
        poly = np.asarray(poly, dtype=np.float64).reshape(8)
        phbb = _poly_hbb(poly)
        px1, py1, px2, py2 = phbb
        best_iou, best_j = -np.inf, -1
        for j, gpoly in enumerate(entry["polys"]):
            gx1, gy1, gx2, gy2 = entry["hbb"][j]
            if px2 < gx1 or gx2 < px1 or py2 < gy1 or gy2 < py1:
                continue
            ov = (iou_poly(poly, gpoly) if task == 1
                  else _hbb_iou(phbb, entry["hbb"][j]))
            if ov > best_iou:
                best_iou, best_j = ov, j
        if best_iou > ovthresh:
            if entry["difficult"][best_j]:
                pass  # neither tp nor fp
            elif not entry["matched"][best_j]:
                entry["matched"][best_j] = True
                tp[i] = 1
            else:
                fp[i] = 1
        else:
            fp[i] = 1

    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    rec = tp_cum / max(npos, 1)
    prec = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)

    if nd:
        f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-16)
        k = int(np.argmax(f1))
        op = dict(f1=float(f1[k]), precision=float(prec[k]),
                  recall=float(rec[k]), conf=float(scores[k]))
    else:
        op = dict(f1=0.0, precision=0.0, recall=0.0, conf=0.0)

    return dict(rec=rec, prec=prec, ap=ap, scores=scores, npos=npos, **op)


def evaluate_detections(
    dets_by_class: Dict[int, Sequence],
    gt_by_class: Dict[int, Dict],
    class_names: Sequence[str],
    ovthresh: float = 0.5,
    use_07_metric: bool = True,
    task: int = 1,
):
    """Full multi-class evaluation.

    Args:
      dets_by_class: {class_id: [(image, score, poly[8]), ...]}.
      gt_by_class:   {class_id: {image: [(poly, difficult), ...]}}.
      task: 1 = oriented boxes (polygon IoU), 2 = horizontal boxes.

    Returns:
      dict with per-class results, map50, and mean max-F1 P/R.
    """
    per_class = {}
    aps = []
    for cid, cname in enumerate(class_names):
        res = voc_eval_class(
            dets_by_class.get(cid, []),
            gt_by_class.get(cid, {}),
            ovthresh,
            use_07_metric,
            task=task,
        )
        per_class[cname] = res
        aps.append(res["ap"])
    return {
        "per_class": per_class,
        "map50": float(np.mean(aps)) if aps else 0.0,
        "mp": float(np.mean([r["precision"] for r in per_class.values()])) if per_class else 0.0,
        "mr": float(np.mean([r["recall"] for r in per_class.values()])) if per_class else 0.0,
    }
