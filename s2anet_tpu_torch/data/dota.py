"""DOTA dataset and batch loader for evaluation (host side, NumPy).

The evaluation part of ``s2anet_tpu/data/dota.py``: YOLO-rotated label
files (``cls x1 y1 ... y4``, normalized) under ``labels/`` beside
``images/``, polygons turned into rotated boxes by the exact min-area
rectangle, letterboxed to ``img_size`` where an image is not square at that
size, and padded targets ``gt_boxes [B, G, 5]``, ``gt_classes [B, G]``,
``gt_mask [B, G]``.

**Image sources.** The machine with the card has no cv2 and may have no
PIL, so images come decoded, in the two forms the JAX package writes:

  * the ``.npy`` sidecar beside each image (the JAX package's
    ``cache_images="disk"``), served only when it is newer than the image
    (``cache_images=""`` here);
  * the packed shard ``images.pack.bin`` (``cache_images="packed"``;
    :mod:`.packed_cache`).

Both hold **BGR** uint8 (they are ``cv2.imread`` output). An image file
without a fresh sidecar is decoded only where PIL is installed; otherwise it
raises. Labels are read from the txt files; no label cache is written.

**Batches** hold ``imgs`` as uint8 **RGB** ``[B, S, S, 3]``; the model
scales them by 1/255 on the device (``S2ANetPredictor.to_input``), where the
JAX loader scales on the host (the two differ by at most 1 ulp in float32).
Augmentation, process-mode workers, shuffling, sharding and rect batching
wait for the training slice.
"""

from __future__ import annotations

import importlib.util
import itertools
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.rbox import poly_to_rbox_np
from . import augment as A
from .packed_cache import PackedImageCache

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
HAVE_PIL = importlib.util.find_spec("PIL") is not None
CACHE_MODES = ("", "packed")
PAD_VALUE = 114  # letterbox border
PREFETCH = 4  # batches the loader runs ahead
_BGR_TO_RGB = torch.tensor([2, 1, 0])


def load_dota_label(path) -> np.ndarray:
    """YOLO-rotated label file -> [N, 9] (cls, x1..y4 normalized)."""
    path = Path(path)
    if not path.exists():
        return np.zeros((0, 9), np.float32)
    rows = []
    for line in path.read_text().splitlines():
        parts = line.split()
        if len(parts) != 9:
            continue
        rows.append([float(v) for v in parts])
    if not rows:
        return np.zeros((0, 9), np.float32)
    arr = np.array(rows, np.float32)
    # rows with a coordinate outside [0, 1] are dropped
    return arr[(arr[:, 1:] >= 0).all(1) & (arr[:, 1:] <= 1).all(1)]


def _img2label(img_path: Path) -> Path:
    parts = list(img_path.parts)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = "labels"
            return Path(*parts).with_suffix(".txt")
    return img_path.with_suffix(".txt")


def decode_image(path) -> np.ndarray:
    """Decode an image file to BGR uint8 with PIL (as ``cv2.imread`` gives
    it); raises where PIL is absent."""
    if not HAVE_PIL:
        raise FileNotFoundError(
            f"{path}: no decoded form of this image. Without PIL the port reads "
            f"the BGR .npy sidecar beside the image (newer than it) or a packed "
            f"shard images.pack.bin (cache_images='packed'), as the JAX package "
            f"writes them")
    from PIL import Image

    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"))
    return np.ascontiguousarray(rgb[:, :, ::-1])


def _sidecar_fresh(path: Path) -> bool:
    npy = path.with_suffix(".npy")
    return (npy.exists() and path.exists()
            and npy.stat().st_mtime >= path.stat().st_mtime)


class DotaDataset:
    """Index of (image, label) pairs, without augmentation."""

    def __init__(
        self,
        source,
        img_size: int = 1024,
        max_gt: int = 512,
        cache_images: str = "",
    ):
        if cache_images not in CACHE_MODES:
            raise ValueError(f"cache_images {cache_images!r}: one of {CACHE_MODES}")
        self.img_size = img_size
        self.max_gt = max_gt
        src = Path(source)
        if src.is_dir():
            self.img_files = sorted(
                p for p in src.rglob("*") if p.suffix.lower() in IMG_EXTS)
        else:  # txt list of image paths
            self.img_files = [Path(line.strip())
                              for line in src.read_text().splitlines() if line.strip()]
        self.label_files = [_img2label(p) for p in self.img_files]
        self.labels = [load_dota_label(p) for p in self.label_files]
        self._pack = None
        if cache_images == "packed" and self.img_files:
            self._pack = PackedImageCache(self.img_files)
            self._pack.build(decode_image)

    def __len__(self):
        return len(self.img_files)

    def load_image(self, i: int) -> np.ndarray:
        """Image i, BGR uint8: from the pack, the fresh sidecar, or PIL."""
        if self._pack is not None:
            return self._pack.get(i)
        path = self.img_files[i]
        if _sidecar_fresh(path):
            return np.load(path.with_suffix(".npy"))
        return decode_image(path)

    def get_sample(self, i: int, out: Optional[np.ndarray] = None) -> Dict:
        """Sample i; ``imgs`` is RGB uint8 ``[S, S, 3]``, written into
        ``out`` when given."""
        img = self.load_image(i)
        h0, w0 = img.shape[:2]
        label = self.labels[i]
        cls = label[:, 0].astype(np.int32)
        polys = label[:, 1:].copy()
        polys[:, 0::2] *= w0
        polys[:, 1::2] *= h0
        if (h0, w0) != (self.img_size, self.img_size):
            img, ratio, pad = A.letterbox(img, (self.img_size, self.img_size), PAD_VALUE)
            polys = A.scale_polys(polys, ratio, pad)
        rboxes = (poly_to_rbox_np(polys).astype(np.float32) if len(polys)
                  else np.zeros((0, 5), np.float32))
        # drop degenerate boxes (zero side)
        ok = (rboxes[:, 2] > 1e-3) & (rboxes[:, 3] > 1e-3)
        rboxes, cls = rboxes[ok], cls[ok]
        g = self.max_gt
        n = min(len(rboxes), g)
        gt_boxes = np.zeros((g, 5), np.float32)
        gt_classes = np.zeros((g,), np.int32)
        gt_mask = np.zeros((g,), bool)
        gt_boxes[:n] = rboxes[:n]
        gt_classes[:n] = cls[:n]
        gt_mask[:n] = True
        if out is None:
            out = np.empty(img.shape, np.uint8)
        # BGR -> RGB: torch's gather runs without the GIL, at several times
        # the speed of NumPy's reversed-stride copy
        torch.index_select(torch.from_numpy(img), 2, _BGR_TO_RGB, out=torch.from_numpy(out))
        return {
            "imgs": out,
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_mask": gt_mask,
            "path": str(self.img_files[i]),
            "orig_shape": (h0, w0),
            "img_shape": tuple(img.shape[:2]),
        }


class BatchLoader:
    """In-order batches, the last one partial, each loaded by one of a pool
    of threads, ``PREFETCH`` batches ahead.

    ``staging``, when given, provides each batch's image buffer:
    ``staging.slot(i)`` returns a writable uint8 ``[B, S, S, 3]`` array for
    batch i and may block until the buffer is free (the evaluation runner
    passes its ring of pinned buffers, :class:`..eval.runner.BatchPipeline`).
    """

    def __init__(self, dataset: DotaDataset, batch_size: int,
                 num_workers: Optional[int] = None,   # None = min(4, cores)
                 staging=None):
        if num_workers is None:
            num_workers = min(4, os.cpu_count() or 1)
        self.ds = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.staging = staging

    def __len__(self):
        return -(-len(self.ds) // self.batch_size)

    def load(self, bi: int, batch_idx) -> Dict:
        b, s = len(batch_idx), self.ds.img_size
        imgs = (self.staging.slot(bi) if self.staging is not None
                else np.empty((b, s, s, 3), np.uint8))[:b]
        samples = [self.ds.get_sample(int(j), out=imgs[k])
                   for k, j in enumerate(batch_idx)]
        out = {k: np.stack([smp[k] for smp in samples])
               for k in ("gt_boxes", "gt_classes", "gt_mask")}
        out["imgs"] = imgs
        out["paths"] = [smp["path"] for smp in samples]
        out["orig_shapes"] = [smp["orig_shape"] for smp in samples]
        out["img_shapes"] = [smp["img_shape"] for smp in samples]
        return out

    def __iter__(self):
        idx = np.arange(len(self.ds))
        batches = enumerate(idx[i * self.batch_size:(i + 1) * self.batch_size]
                            for i in range(len(self)))
        if self.num_workers <= 1:
            for bi, batch_idx in batches:
                yield self.load(bi, batch_idx)
            return
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = deque(pool.submit(self.load, *a)
                            for a in itertools.islice(batches, PREFETCH))
            while pending:
                batch = pending.popleft().result()
                nxt = next(batches, None)
                if nxt is not None:
                    pending.append(pool.submit(self.load, *nxt))
                yield batch
