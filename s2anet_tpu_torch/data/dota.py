"""DOTA dataset and batch loader (host side, NumPy).

``s2anet_tpu/data/dota.py`` in thread mode: YOLO-rotated label
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

**Training** (``augment=True``): mixup, the HSV jitter, 90-degree
rotations and the two flips of the JAX ``get_sample``, drawing from the
batch's generator in the JAX order (the mosaic and mixup draws come first
even where their probability is 0); mosaic and the affine warp are not
ported (the trainer refuses them, :func:`.augment.not_ported`). :class:`BatchLoader` shuffles per epoch
(``default_rng(seed + epoch)``), shards by ``shard::num_shards`` at equal
lengths and seeds each batch's generator with ``seed * 100003 + epoch +
batch``, so its batches equal the JAX loader's.

**Batches** hold ``imgs`` as uint8 **RGB** ``[B, S, S, 3]``; the train step
scales them by ``float32(1/255)`` on the device, as the JAX loader scales
on the host (equal in float32). Process-mode workers and rect batching are
not ported.
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
    """Index of (image, label) pairs, augmented on the fly when ``augment``."""

    def __init__(
        self,
        source,
        img_size: int = 1024,
        max_gt: int = 512,
        cache_images: str = "",
        augment: bool = False,
        fliplr: float = 0.5,
        flipud: float = 0.0,
        rot90: bool = True,
        hsv=(0.0, 0.0, 0.0),
        mixup: float = 0.0,
    ):
        if cache_images not in CACHE_MODES:
            raise ValueError(f"cache_images {cache_images!r}: one of {CACHE_MODES}")
        self.img_size = img_size
        self.max_gt = max_gt
        self.augment = augment
        self.fliplr = fliplr
        self.flipud = flipud
        self.rot90 = rot90
        self.hsv = tuple(hsv)
        self.mixup = mixup
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

    def _load_fitted(self, i: int):
        """Image i letterboxed to the square size (BGR uint8), its
        pixel-space polygons, classes and original (h, w)."""
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
        return img, polys, cls, (h0, w0)

    def _augment(self, img, polys, cls, rng: np.random.Generator):
        """The JAX ``get_sample`` augmentations, in its order of draws."""
        rng.uniform()  # the mosaic draw (mosaic is not ported: always 0)
        if rng.uniform() < self.mixup:
            img2, polys2, cls2, _ = self._load_fitted(int(rng.integers(0, len(self))))
            img, polys, cls = A.mixup(img, polys, cls, img2, polys2, cls2, rng)
        if any(self.hsv):
            img = A.hsv_augment(img, *self.hsv, rng=rng)
        if self.rot90:
            img, polys = A.rot90_image_and_polys(img, polys, int(rng.integers(0, 4)))
        if rng.uniform() < self.fliplr:
            polys = A.fliplr_polys(img.shape[1], polys)
            img = img[:, ::-1]
        if rng.uniform() < self.flipud:
            polys = A.flipud_polys(img.shape[0], polys)
            img = img[::-1]
        keep = A.filter_polys_center_inside(polys, img.shape[0], img.shape[1])
        return img, polys[keep], cls[keep]

    def get_sample(self, i: int, rng: Optional[np.random.Generator] = None,
                   out: Optional[np.ndarray] = None) -> Dict:
        """Sample i; ``imgs`` is RGB uint8 ``[S, S, 3]``, written into
        ``out`` when given. Augmentation draws from ``rng``."""
        img, polys, cls, (h0, w0) = self._load_fitted(i)
        if self.augment:
            img, polys, cls = self._augment(img, polys, cls, rng or np.random.default_rng())
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
        # the speed of NumPy's reversed-stride copy (a flipped or rotated
        # view is made contiguous first: torch takes no negative strides)
        torch.index_select(torch.from_numpy(np.ascontiguousarray(img)), 2, _BGR_TO_RGB,
                           out=torch.from_numpy(out))
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
    """Batches, each loaded by one of a pool of threads, ``PREFETCH``
    batches ahead: in order, or shuffled per epoch (:meth:`set_epoch`), of
    this shard's share, the last one partial unless ``drop_last``.

    ``staging``, when given, provides each batch's image buffer:
    ``staging.slot(i)`` returns a writable uint8 ``[B, S, S, 3]`` array for
    batch i and may block until the buffer is free (the runner and the
    trainer pass their ring of pinned buffers,
    :class:`..eval.runner.BatchPipeline`).
    """

    def __init__(self, dataset: DotaDataset, batch_size: int,
                 num_workers: Optional[int] = None,   # None = min(4, cores)
                 staging=None, shuffle: bool = False, seed: int = 0,
                 shard: int = 0, num_shards: int = 1, drop_last: bool = False):
        if num_workers is None:
            num_workers = min(4, os.cpu_count() or 1)
        self.ds = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.staging = staging
        self.shuffle = shuffle
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        n = len(self.ds) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        # every shard gets len(ds) // num_shards samples
        return idx[self.shard:: self.num_shards][: len(self.ds) // self.num_shards]

    def load(self, bi: int, batch_idx) -> Dict:
        b, s = len(batch_idx), self.ds.img_size
        imgs = (self.staging.slot(bi) if self.staging is not None
                else np.empty((b, s, s, 3), np.uint8))[:b]
        rng = np.random.default_rng(self.seed * 100003 + self.epoch + bi)
        samples = [self.ds.get_sample(int(j), rng, out=imgs[k])
                   for k, j in enumerate(batch_idx)]
        out = {k: np.stack([smp[k] for smp in samples])
               for k in ("gt_boxes", "gt_classes", "gt_mask")}
        out["imgs"] = imgs
        out["paths"] = [smp["path"] for smp in samples]
        out["orig_shapes"] = [smp["orig_shape"] for smp in samples]
        out["img_shapes"] = [smp["img_shape"] for smp in samples]
        return out

    def __iter__(self):
        idx = self._indices()
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
