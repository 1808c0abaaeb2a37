"""Evaluation runner: the port's ``s2anet_tpu/eval/runner.py``.

Batches of chips go through a detection step (an
:class:`..predict.S2ANetPredictor`, or any callable from a uint8 RGB batch
``[B, S, S, 3]`` to the fixed-size buffers ``(det_boxes [B, K, 6],
det_labels [B, K], det_valid [B, K])``); the detections become polygons
in each chip's original frame (letterbox undone) and are either evaluated
on the chips against their YOLO labels (``is_map_split``) or merged back
into full images by cross-chip polygon NMS and evaluated against DOTA
``labelTxt`` files. Per class: VOC AP at IoU 0.5 with difficult GT left
out, and the max-F1 precision and recall.

**Overlap on a CUDA device** (:class:`BatchPipeline`, which
``predict.serve_chips`` runs through too). The host fetches and
post-processes batch i-1 while the card runs batch i, as the JAX runner
does by fetching one iteration late. A plain ``.cpu()`` of batch i-1's
outputs, issued after batch i is enqueued on the same stream, would wait
for batch i too, so:

  * the loader stacks each batch straight into a ring of pinned uint8
    buffers, and a side stream copies it to the card with
    ``non_blocking``; the compute stream waits for that copy only;
  * batch i's three detection buffers are copied into pinned host tensors
    with ``non_blocking`` and an event is recorded after them; batch i-1 is
    read after *its* event;
  * a pinned input buffer is written again only after the event of the
    copy that read it.

**int8 serving** (``cfg.model.quant == "int8"``), in the JAX runner's
order: the scope is checked before any loading, the step (a predictor
built with the config, which folded BatchNorm at load) calibrates on the
first ``quant_calib_batches`` batches, a short one wrap-padded to the
batch size (:func:`calibration_batches`), then the loop runs int8.

**Rect batches** (``cfg.eval.rect``): the loader orders the images by
aspect ratio and letterboxes each batch to its own shape; the pipeline's
slots hold the largest such shape and each batch is staged as one
contiguous copy of its own. Calibration stays on the square letterbox, as
in the JAX runner.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.augment import unletterbox_rboxes
from ..data.dota import PREFETCH, BatchLoader, DotaDataset
from ..data.merge import merge_chip_detections
from ..data.split import parse_dota_label
from ..ops.polyiou import rbox_vertices_np
from ..ops.quant import parse_scope
from ..utils.profiler import span
from .voc_eval import evaluate_detections


def detections_to_polys(det_boxes: np.ndarray, det_valid: np.ndarray):
    """[K, 6] (x,y,w,h,theta,score) + mask -> ([n,8] polys, [n] scores)."""
    boxes = det_boxes[det_valid]
    if len(boxes) == 0:
        return np.zeros((0, 8)), np.zeros((0,))
    polys = rbox_vertices_np(boxes[:, :5]).reshape(-1, 8)
    return polys, boxes[:, 5]


def gt_from_yolo_labels(dataset: DotaDataset, num_classes: int,
                        dims: Optional[Dict[str, tuple]] = None):
    """Chip-level GT from the dataset's YOLO labels, in the original image
    frame (labels are normalized by the original dims; detections are
    un-letterboxed to the same frame before matching).

    ``dims`` maps image stem -> (h0, w0) (the runner records them from the
    loader); an image with labels and no entry is read for its shape.
    """
    gt_by_class: Dict[int, Dict] = {c: {} for c in range(num_classes)}
    size = dataset.img_size
    for i, (img_path, label) in enumerate(zip(dataset.img_files, dataset.labels)):
        img_name = Path(img_path).stem
        h0 = w0 = size
        if len(label):
            if dims is not None and img_name in dims:
                h0, w0 = dims[img_name]
            else:
                h0, w0 = dataset.load_image(i).shape[:2]
        for c in range(num_classes):
            gt_by_class[c].setdefault(img_name, [])
        for row in label:
            cid = int(row[0])
            poly = row[1:].copy()
            poly[0::2] *= w0
            poly[1::2] *= h0
            gt_by_class[cid][img_name].append((poly.astype(np.float64), False))
    return gt_by_class


def gt_from_dota_dir(gt_dir, class_names, image_names=None):
    """Full-image GT from DOTA labelTxt files (difficult respected)."""
    name_to_id = {n: i for i, n in enumerate(class_names)}
    gt_by_class: Dict[int, Dict] = {c: {} for c in range(len(class_names))}
    for p in sorted(Path(gt_dir).glob("*.txt")):
        img = p.stem
        if image_names is not None and img not in image_names:
            continue
        for c in range(len(class_names)):
            gt_by_class[c].setdefault(img, [])
        for obj in parse_dota_label(p):
            cid = name_to_id.get(obj["name"])
            if cid is None:
                continue
            gt_by_class[cid][img].append(
                (np.asarray(obj["poly"], np.float64), bool(obj["difficult"])))
    return gt_by_class


def save_dota_results(dets_by_class, class_names, out_dir):
    """Dump detections in the DOTA submission format: one
    ``Task1_<classname>.txt`` per class, lines ``imgname score x1 y1 ... y4``.
    Every class gets a file (empty when no detections), so the directory is
    a complete submission."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for cid, cname in enumerate(class_names):
        lines = []
        for img, score, poly in dets_by_class.get(cid, []):
            coords = " ".join(f"{v:.2f}" for v in np.asarray(poly).ravel()[:8])
            lines.append(f"{img} {score:.6f} {coords}")
        (out_dir / f"Task1_{cname}.txt").write_text(
            "\n".join(lines) + ("\n" if lines else ""))
    return out_dir


class BatchPipeline:
    """Fixed-size uint8 RGB batches ``[B, H, W, 3]`` through a detection
    step, one batch deep.

    Batch i is staged in slot ``i % n`` of a ring of ``n`` buffers (pinned
    on a CUDA device), each of ``B * capacity * 3`` bytes (``capacity``
    pixels an image, ``S * S`` by default): :meth:`slot` returns the slot
    as a contiguous ``[B, H, W, 3]`` array of the batch's own shape (``S x
    S`` unless given; rect batches differ batch to batch) once batch ``i -
    n`` has been read from it, and may be called from a loader thread. The
    caller fills the slot, pads it to B rows, and passes ``(b, meta)`` to
    :meth:`run`, which submits it (``step(x)``, or ``step(x, meta)`` with
    ``with_batch``) and yields batch i-1's outputs once batch i is
    submitted. On a CUDA device the slot is copied to the card on a side
    stream (the compute stream waits for that copy only) and the outputs
    into alternating pinned host buffers, read after their batch's event;
    elsewhere the step runs as it is called. The trainer takes the staged
    batches alone (:meth:`stage`; ``step`` None, ``device`` given). Use it
    as a context manager: leaving it releases any loader thread still
    waiting.

    Under a profiler the host's parts are the spans
    ``s2anet.pipeline.wait_loader`` (the next ``(b, meta)``),
    ``s2anet.pipeline.stage`` (the slot's copy to the device),
    ``s2anet.pipeline.copy_out`` (the outputs into the pinned host buffers)
    and ``s2anet.pipeline.wait_device`` (a batch's outputs on the host).
    """

    def __init__(self, step, batch_size: int, img_size: int, n: int = PREFETCH + 2,
                 device=None, with_batch: bool = False, capacity: Optional[int] = None):
        self.device = device if device is not None else getattr(step, "device", None)
        self.cuda = self.device is not None and self.device.type == "cuda"
        self.fn = getattr(step, "predict", step)
        self.with_batch = with_batch  # the step also takes the batch (its gts)
        self.n = n
        self.batch_size = batch_size
        self.img_size = img_size
        self.capacity = capacity or img_size * img_size
        self.bufs = [torch.empty(batch_size * self.capacity * 3, dtype=torch.uint8,
                                 pin_memory=self.cuda) for _ in range(n)]
        self.views = [b.numpy() for b in self.bufs]
        self._shapes = [(img_size, img_size)] * n  # per slot: its batch's (H, W)
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._events = [None] * n  # per slot: the copy that read it last
        self._read = [-1] * n  # per slot: the last batch read from it
        self._cond = threading.Condition()
        self._closed = False
        self._host = [None, None]

    def slot(self, i: int, shape=None) -> np.ndarray:
        """The buffer of batch i as a contiguous ``[B, H, W, 3]`` array,
        ``(H, W)`` = ``shape`` (default ``(S, S)``), once it is free."""
        s = i % self.n
        h, w = shape or (self.img_size, self.img_size)
        if h * w > self.capacity:
            raise ValueError(f"batch shape {h}x{w} exceeds the slots' {self.capacity} "
                             f"pixels an image")
        with self._cond:
            self._cond.wait_for(lambda: self._closed or self._read[s] >= i - self.n)
        if self._events[s] is not None:
            self._events[s].synchronize()
        self._shapes[s] = (h, w)
        return self._view(self.views[s], s)

    def _view(self, buf, s: int):
        """Slot s's first ``B * H * W * 3`` bytes as ``[B, H, W, 3]``."""
        h, w = self._shapes[s]
        return buf[:self.batch_size * h * w * 3].reshape(self.batch_size, h, w, 3)

    def _release(self, i: int, event=None):
        with self._cond:
            self._events[i % self.n] = event
            self._read[i % self.n] = i
            self._cond.notify_all()

    def stage(self, i: int) -> torch.Tensor:
        """Slot ``i % n`` as a uint8 tensor on the device, the slot released
        to the loader. On a CUDA device the copy runs on the side stream and
        the compute stream waits for it; elsewhere it is a copy."""
        s = i % self.n
        with span("s2anet.pipeline.stage"):
            src = self._view(self.bufs[s], s)
            if not self.cuda:
                x = src.clone()
                self._release(i)
                return x
            compute = torch.cuda.current_stream(self.device)
            copied = torch.cuda.Event()
            with torch.cuda.stream(self.stream):
                x = src.to(self.device, non_blocking=True)
                copied.record(self.stream)
            compute.wait_event(copied)
            x.record_stream(compute)  # x is freed only after the compute stream used it
            self._release(i, copied)
            return x

    def _submit(self, i: int, meta):
        """Run the step on slot ``i % n``; returns a handle for :meth:`_fetch`."""
        extra = (meta,) if self.with_batch else ()
        if not self.cuda:
            out = self.fn(self._view(self.views[i % self.n], i % self.n), *extra)
            self._release(i)
            return out
        outs = self.fn(self.stage(i), *extra)
        with span("s2anet.pipeline.copy_out"):
            if self._host[i % 2] is None:
                self._host[i % 2] = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                     for t in outs]
            host = self._host[i % 2]
            for h, t in zip(host, outs):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host, done

    def _fetch(self, handle, b: int, meta, seconds):
        """``(det_boxes, det_labels, det_valid[, loss_items])`` of a
        submitted batch, the detections cut to its ``b`` real rows, as NumPy
        arrays (on a CUDA device, views of pinned buffers that batch i + 2
        overwrites)."""
        with span("s2anet.pipeline.wait_device", seconds, "device_wait"):
            if self.cuda:
                host, done = handle
                done.synchronize()
                handle = [h.numpy() for h in host]
            outs = tuple(np.asarray(a)[:b] for a in handle[:3]) + tuple(
                np.asarray(a) for a in handle[3:])
        return outs, b, meta

    def run(self, batches, seconds: Dict[str, float]):
        """Yield ``(outputs, b, meta)`` per item ``(b, meta)`` of
        ``batches`` (the i-th comes once slot i holds batch i, padded),
        ``outputs`` cut to the batch's ``b`` real rows, one batch late.
        ``seconds`` gathers the host's waits for ``batches``
        (``loader_wait``) and for the device's outputs (``device_wait``)."""
        pending = None
        batches = iter(batches)
        for i in itertools.count():
            with span("s2anet.pipeline.wait_loader", seconds, "loader_wait"):
                item = next(batches, None)
            if item is None:
                break
            b, meta = item
            handle = self._submit(i, meta)
            if pending is not None:
                yield self._fetch(*pending, seconds)  # batch i-1, while batch i runs
            pending = (handle, b, meta)
        if pending is not None:
            yield self._fetch(*pending, seconds)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def calibration_batches(dataset: DotaDataset, batch_size: int, k: int):
    """The first ``k`` batches of ``dataset`` in order, uint8 RGB ``[B, S,
    S, 3]``, a short batch wrap-padded to ``batch_size`` (one loader
    thread: a few batches)."""
    out = []
    for batch in itertools.islice(BatchLoader(dataset, batch_size, num_workers=1), k):
        imgs = batch["imgs"]
        if len(imgs) < batch_size:
            imgs = imgs[np.arange(batch_size) % len(imgs)]
        out.append(imgs)
    return out


def score_detections(chip_dets, cfg, dataset: Optional[DotaDataset] = None,
                     chip_dims=None, save_dir=None):
    """The evaluation of per-chip detections ``{chip: [(class_id, score,
    poly[8])]}`` (chip frame): against the chips' YOLO labels in
    ``dataset`` (``is_map_split``; ``chip_dims`` maps chip -> original
    (h, w)), or merged into full images and scored against the labelTxt
    files of ``cfg.data.val_gt_dir``. Returns dict(map50, mp, mr,
    per_class)."""
    names = cfg.data.names
    if cfg.eval.is_map_split:
        dets_by_class = defaultdict(list)
        for chip, dets in chip_dets.items():
            for cid, sc, poly in dets:
                dets_by_class[cid].append((chip, sc, poly))
        gt_by_class = gt_from_yolo_labels(dataset, cfg.model.num_classes, dims=chip_dims)
        if save_dir is not None:
            save_dota_results(dets_by_class, names, Path(save_dir) / "chip_results")
    else:
        if save_dir is not None:
            chip_by_class = defaultdict(list)
            for chip, dets in chip_dets.items():
                for cid, sc, poly in dets:
                    chip_by_class[cid].append((chip, sc, poly))
            save_dota_results(chip_by_class, names, Path(save_dir) / "chip_results")
        merged = merge_chip_detections(chip_dets, cfg.eval.merge_nms_thr)
        dets_by_class = defaultdict(list)
        for img, dets in merged.items():
            for cid, sc, poly in dets:
                dets_by_class[cid].append((img, sc, poly))
        gt_by_class = gt_from_dota_dir(cfg.data.val_gt_dir, names)
        if save_dir is not None:
            save_dota_results(dets_by_class, names, Path(save_dir) / "merged_results")
    return evaluate_detections(
        dict(dets_by_class), gt_by_class, names, ovthresh=cfg.eval.iou_thres,
        use_07_metric=cfg.eval.use_07_metric, task=cfg.eval.task)


def evaluate_on_chips(step, cfg, dataset: Optional[DotaDataset] = None,
                      save_dir=None, verbose: bool = False, with_loss: bool = False):
    """Run detection over the val chips and compute mAP50.

    ``step`` is an :class:`..predict.S2ANetPredictor` or a callable from a
    uint8 RGB batch to detection buffers; ``cfg`` a :class:`..config.Config`.
    With ``with_loss`` it is called as ``step(imgs, batch)`` and returns the
    four loss items ``[4]`` after the detection buffers; the result then
    holds ``val/{fam,odm}_{cls,reg}_loss``, their mean over the real images
    (a partial batch, padded by wrapping its real images and gts, weighs as
    its real count).
    Returns dict(map50, mp, mr, per_class, images_per_sec, n_images,
    seconds (the loop's wall time and the host's waits for the loader and
    the device and its post-processing), and chip_dets: {chip: [(class_id,
    score, poly[8])]} in the chip's frame).
    ``save_dir`` dumps per-class DOTA-format result txts (chip-level, and
    merged when ``is_map_split`` is off). Under ``cfg.eval.rect`` the
    batches are rect batches (``BatchLoader(rect=True)``), each of its own
    shape; not with ``with_loss``. A step that ``needs_calibration``
    (an int8 predictor) is calibrated first, on the first
    ``cfg.model.quant_calib_batches`` batches; the result then holds the
    ranges (``quant_ranges``).
    """
    if cfg.model.quant == "int8":  # a typo in the scope fails before any loading
        parse_scope(cfg.model.quant_scope)
    rect = bool(cfg.eval.rect)
    if rect and with_loss:
        raise ValueError("rect evaluation computes no val losses (the losses take "
                         "one square image size)")
    dataset = dataset or DotaDataset(
        cfg.data.val_list or cfg.data.root, img_size=cfg.data.img_size,
        max_gt=cfg.data.max_gt, cache_images=cfg.data.cache)
    bs = cfg.eval.batch_size
    ranges = None
    if getattr(step, "needs_calibration", False):
        ranges = step.calibrate(calibration_batches(
            dataset, bs, max(1, int(cfg.model.quant_calib_batches))))
    loader = BatchLoader(dataset, bs, num_workers=cfg.data.workers or None,
                         rect=rect, rect_stride=cfg.eval.rect_stride, mode=cfg.data.loader)
    pipeline = BatchPipeline(step, bs, dataset.img_size, with_batch=with_loss,
                             capacity=loader._img_capacity())
    loader.staging = pipeline

    def batches():
        for i, batch in enumerate(loader):
            b = len(batch["paths"])
            if b < bs:  # pad by wrapping the real images (and their gts)
                sel = np.arange(bs - b) % b
                view = pipeline.slot(i, batch["imgs"].shape[1:3])
                view[b:] = view[sel]
                for key in ("gt_boxes", "gt_classes", "gt_mask"):
                    batch[key] = np.concatenate([batch[key], batch[key][sel]], 0)
            yield b, batch

    chip_dets: Dict[str, list] = {}
    chip_dims: Dict[str, tuple] = {}
    n_imgs = 0
    mean_loss = np.zeros(4)
    # host seconds: waiting for the loader, waiting for the device's
    # outputs, and post-processing them
    seconds = {"loader_wait": 0.0, "device_wait": 0.0, "post": 0.0}
    t_wall0 = time.perf_counter()
    with pipeline:
        for outs, b, batch in pipeline.run(batches(), seconds):
            # post-processing of batch i-1 while the device runs batch i
            with span("s2anet.eval.post", seconds, "post"):
                det_boxes, det_labels, det_valid = outs[:3]
                if with_loss:  # running mean weighted by the real images
                    mean_loss += (outs[3] - mean_loss) * (b / (n_imgs + b))
                n_imgs += b
                for k in range(b):
                    chip_name = Path(batch["paths"][k]).stem
                    boxes_k = det_boxes[k].copy()
                    h0, w0 = batch["orig_shapes"][k]
                    th, tw = batch["img_shapes"][k]
                    if (h0, w0) != (th, tw):
                        # undo the letterbox; out-of-frame detections stay as they are
                        ratio = min(th / h0, tw / w0)
                        pad = ((tw - w0 * ratio) / 2, (th - h0 * ratio) / 2)
                        boxes_k[:, :5] = unletterbox_rboxes(boxes_k[:, :5], ratio, pad)
                    polys, scores = detections_to_polys(boxes_k, det_valid[k])
                    labels = det_labels[k][det_valid[k]]
                    chip_dets[chip_name] = [(int(cid), float(sc), poly)
                                            for cid, sc, poly in zip(labels, scores, polys)]
                    chip_dims[chip_name] = (h0, w0)
    t_infer = time.perf_counter() - t_wall0

    out = score_detections(chip_dets, cfg, dataset, chip_dims, save_dir)
    # end-to-end wall rate of the pipelined loop: loading, the step and the
    # post-processing overlapped, first-batch autotuning included
    out["images_per_sec"] = n_imgs / max(t_infer, 1e-9)
    out["n_images"] = n_imgs
    out["seconds"] = dict(seconds, loop=t_infer)
    out["chip_dets"] = chip_dets
    if ranges is not None:
        out["quant_ranges"] = ranges
    if with_loss and n_imgs:
        for i, key in enumerate(("val/fam_cls_loss", "val/fam_reg_loss",
                                 "val/odm_cls_loss", "val/odm_reg_loss")):
            out[key] = float(mean_loss[i])
    if verbose:
        for cname, res in out["per_class"].items():
            print(f"{cname:20s} AP50 {res['ap']:.4f}")
        print(f"mAP50 {out['map50']:.4f}  ({out['images_per_sec']:.1f} img/s)")
    return out
