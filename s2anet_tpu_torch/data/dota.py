"""DOTA dataset and batch loader (host side, NumPy).

``s2anet_tpu/data/dota.py``: YOLO-rotated label
files (``cls x1 y1 ... y4``, normalized) under ``labels/`` beside
``images/``, polygons turned into rotated boxes by the exact min-area
rectangle, letterboxed to ``img_size`` where an image is not square at that
size, and padded targets ``gt_boxes [B, G, 5]``, ``gt_classes [B, G]``,
``gt_mask [B, G]``.

**Image sources.** The machine with the card has no cv2 and may have no
PIL. An image is read, in this order, from:

  * the packed shard ``images.pack.bin`` (``cache_images="packed"``;
    :mod:`.packed_cache`), the JAX package's format;
  * the ``.npy`` sidecar beside the image (the JAX package's
    ``cache_images="disk"``), served only when it is newer than the image
    (``cache_images=""`` here);
  * the image file itself: a PNG or BMP by :mod:`.image` (cv2's pixels),
    any other format by PIL where PIL is installed; otherwise it raises.

All give **BGR** uint8 (``cv2.imread`` output). Labels are read from the
txt files; no label cache is written.

**Training** (``augment=True``): the 4-image mosaic and its centre crop,
mixup, the scale / translate warp, the HSV jitter, 90-degree rotations and
the two flips of the JAX ``get_sample``, drawing from the batch's
generator in the JAX order (the mosaic and mixup draws come first even
where their probability is 0). :class:`BatchLoader` shuffles per epoch
(``default_rng(seed + epoch)``), shards by ``shard::num_shards`` at equal
lengths and seeds each batch's generator with ``seed * 100003 + epoch +
batch``, so its batches equal the JAX loader's, in either mode.

**Batches** hold ``imgs`` as uint8 **RGB** ``[B, S, S, 3]``; the train step
scales them by ``float32(1/255)`` on the device, as the JAX loader scales
on the host (equal in float32).

**Process mode** (``mode="process"``, the JAX ``BatchLoader`` mode): forked
worker processes write whole batches into slots of one anonymous shared
memory map, and the iterating process copies each, in order, into the
batch's buffer (the ``staging`` slot, or a new array). The workers are
forked from the training process, which has already initialised CUDA: they
run only the dataset's host code (NumPy, and PyTorch CPU operations on one
thread) and never touch CUDA. Where the platform has no ``fork`` the
loader raises (the JAX loader falls back to threads).

**Rect batching** (``BatchLoader(rect=True)``, evaluation only): the images
are ordered by aspect ratio (:meth:`DotaDataset.shapes`, cached in
``shapes.cache.npz`` in the JAX package's format) and each batch is
letterboxed to its own ``[B, th, tw, 3]``, the smallest shape of its
images' aspect ratios rounded up to ``rect_stride``, as the JAX loader plans
it; a side can exceed ``S`` by one stride (:meth:`BatchLoader._img_capacity`).
"""

from __future__ import annotations

import contextlib
import itertools
import mmap
import multiprocessing as mp
import multiprocessing.connection as mp_connection
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.rbox import poly_to_rbox_np
from . import augment as A
from . import image
from .packed_cache import PackedImageCache, _content_key

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
CACHE_MODES = ("", "packed")
LOADER_MODES = ("thread", "process")
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
    """Decode an image file to BGR uint8, as ``cv2.imread`` gives it
    (:func:`.image.imread`); raises :class:`FileNotFoundError` where no
    reader of this process reads it."""
    img = image.imread(path)
    if img is None:
        raise FileNotFoundError(f"{path}: not an image ({image.FORMATS}, or PIL's)")
    return img


def sidecar_fresh(path: Path) -> bool:
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
        mosaic: float = 0.0,
        translate: float = 0.0,
        scale: float = 0.0,
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
        self.mosaic = mosaic
        self.translate = translate
        self.scale = scale
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

    def shapes(self) -> np.ndarray:
        """Per-image original ``(h0, w0)``, ``[N, 2]`` int32, read once and
        cached in ``shapes.cache.npz`` beside the first image under the
        images' content key, the JAX package's file: either package reads
        the other's (the cache is not written into a read-only directory).
        No pixel is read: the shape comes from the pack's index, the fresh
        sidecar's ``.npy`` header, a PNG or BMP header (:mod:`.image`) or,
        where PIL is installed, another image file's header; an image with
        none of these gets ``(img_size, img_size)``, the JAX package's shape for an image it cannot read (a
        file that PIL cannot read raises here, as it does in
        :meth:`load_image`)."""
        if getattr(self, "_shapes", None) is not None:
            return self._shapes
        cache = self.img_files[0].parent / "shapes.cache.npz" if self.img_files else None
        key = _content_key(self.img_files)
        if cache is not None and cache.exists():
            z = np.load(cache, allow_pickle=False)
            if str(z["key"]) == key:
                self._shapes = z["shapes"]
                return self._shapes
        shapes = np.zeros((len(self.img_files), 2), np.int32)
        for i in range(len(self.img_files)):
            shapes[i] = self._header_shape(i)
        self._shapes = shapes
        if cache is not None and os.access(cache.parent, os.W_OK):
            np.savez(cache, key=np.str_(key), shapes=shapes)
        return shapes

    def _header_shape(self, i: int):
        if self._pack is not None:
            return self._pack.shape(i)[:2]
        path = self.img_files[i]
        if sidecar_fresh(path):
            return np.load(path.with_suffix(".npy"), mmap_mode="r").shape[:2]
        shape = image.read_shape(path) if path.exists() else None
        return shape if shape is not None else (self.img_size, self.img_size)

    def load_image(self, i: int) -> np.ndarray:
        """Image i, BGR uint8: from the pack, the fresh sidecar, or the file
        (:func:`decode_image`)."""
        if self._pack is not None:
            return self._pack.get(i)
        path = self.img_files[i]
        if sidecar_fresh(path):
            return np.load(path.with_suffix(".npy"))
        return decode_image(path)

    def _load_fitted(self, i: int, target_shape=None):
        """Image i letterboxed to ``target_shape`` (default the square
        size; BGR uint8), its pixel-space polygons, classes and original
        (h, w)."""
        img = self.load_image(i)
        h0, w0 = img.shape[:2]
        label = self.labels[i]
        cls = label[:, 0].astype(np.int32)
        polys = label[:, 1:].copy()
        polys[:, 0::2] *= w0
        polys[:, 1::2] *= h0
        tgt = tuple(target_shape or (self.img_size, self.img_size))
        if (h0, w0) != tgt:
            img, ratio, pad = A.letterbox(img, tgt, PAD_VALUE)
            polys = A.scale_polys(polys, ratio, pad)
        return img, polys, cls, (h0, w0)

    def _augment(self, img, polys, cls, rng: np.random.Generator):
        """The JAX ``get_sample`` augmentations, in its order of draws."""
        if rng.uniform() < self.mosaic:
            others = [self._load_fitted(int(rng.integers(0, len(self))))[:3]
                      for _ in range(3)]
            canvas, polys, cls = A.mosaic4([(img, polys, cls)] + others, self.img_size,
                                           PAD_VALUE, rng)
            # 2s x 2s canvas -> its centre s x s (object scale kept)
            img, polys, cls = A.mosaic_center_crop(canvas, polys, cls, self.img_size)
        if rng.uniform() < self.mixup:
            img2, polys2, cls2, _ = self._load_fitted(int(rng.integers(0, len(self))))
            img, polys, cls = A.mixup(img, polys, cls, img2, polys2, cls2, rng)
        if self.translate or self.scale:
            img, polys = A.random_perspective_rotation(img, polys, 0.0, self.translate,
                                                       self.scale, rng)
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
                   out: Optional[np.ndarray] = None, target_shape=None) -> Dict:
        """Sample i; ``imgs`` is RGB uint8 ``[S, S, 3]`` (or
        ``target_shape``), written into ``out`` when given. Augmentation
        draws from ``rng``."""
        img, polys, cls, (h0, w0) = self._load_fitted(i, target_shape)
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
    """Batches, each loaded by one of a pool of threads (``mode="thread"``)
    or of forked worker processes (``mode="process"``, see the module
    docstring), ``PREFETCH`` batches ahead (or one a worker process, if
    more): in order, or shuffled per epoch (:meth:`set_epoch`), of this
    shard's share, the last one partial unless ``drop_last``. Both modes
    give the same batches: each batch's generator is seeded by its index.

    ``staging``, when given, provides each batch's image buffer:
    ``staging.slot(i, (th, tw))`` returns a writable contiguous uint8
    ``[B, th, tw, 3]`` array for batch i and may block until the buffer is
    free (the runner and the trainer pass their ring of pinned buffers,
    :class:`..eval.runner.BatchPipeline`).

    With ``rect`` the batches follow :meth:`_batch_plan`: shape-ordered,
    each letterboxed to its own target shape (not with ``shuffle``).
    """

    def __init__(self, dataset: DotaDataset, batch_size: int,
                 num_workers: Optional[int] = None,   # None: see below
                 staging=None, shuffle: bool = False, seed: int = 0,
                 shard: int = 0, num_shards: int = 1, drop_last: bool = False,
                 rect: bool = False, rect_stride: int = 32, rect_pad: float = 0.5,
                 mode: str = "thread"):
        if rect and shuffle:
            raise ValueError("rect batching is shape-ordered (evaluation only): "
                             "not with shuffle")
        if mode not in LOADER_MODES:
            raise ValueError(f"loader mode {mode!r}: one of {LOADER_MODES}")
        if mode == "process" and "fork" not in mp.get_all_start_methods():
            raise RuntimeError("loader mode 'process' forks its workers, and this platform "
                               "has no fork: use mode 'thread'")
        if num_workers is None:  # as the JAX loader: every core, or up to 4 threads
            cores = os.cpu_count() or 1
            num_workers = cores if mode == "process" else min(4, cores)
        self.mode = mode
        self.ds = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.staging = staging
        self.shuffle = shuffle
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.rect = rect
        self.rect_stride = rect_stride
        self.rect_pad = rect_pad
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

    def _batch_plan(self):
        """``[(batch indices, target (th, tw) or None)]``, the JAX loader's
        plan. Under ``rect`` the indices are stably sorted by aspect ratio
        h0 / w0 and each batch's target is the shape of its ratios, ``[max,
        1]`` when all are below 1, ``[1, 1 / min]`` when all are above,
        else ``[1, 1]``, each side ``ceil(v * S / stride + pad) * stride``."""
        idx = self._indices()
        nb, bs = len(self), self.batch_size
        if not self.rect:
            return [(idx[i * bs:(i + 1) * bs], None) for i in range(nb)]
        shapes = self.ds.shapes()[idx].astype(np.float64)
        ar = shapes[:, 0] / shapes[:, 1]
        idx = idx[np.argsort(ar, kind="stable")]
        ar = np.sort(ar, kind="stable")
        s, st, pad = self.ds.img_size, self.rect_stride, self.rect_pad
        plan = []
        for i in range(nb):
            sl = slice(i * bs, (i + 1) * bs)
            lo, hi = float(ar[sl].min()), float(ar[sl].max())
            shape = [hi, 1.0] if hi < 1 else [1.0, 1.0 / lo] if lo > 1 else [1.0, 1.0]
            plan.append((idx[sl], tuple(int(np.ceil(v * s / st + pad) * st) for v in shape)))
        return plan

    def _img_capacity(self) -> int:
        """The most pixels an image of a batch can have: ``S * S``, or under
        ``rect`` the square of the largest side a target can take (one
        stride past ``S`` at most)."""
        s = self.ds.img_size
        if not self.rect:
            return s * s
        m = int(np.ceil(s / self.rect_stride + self.rect_pad) * self.rect_stride)
        return m * m

    def _shape(self, target_shape):
        s = self.ds.img_size
        return tuple(target_shape or (s, s))

    def _buffer(self, bi: int, b: int, shape) -> np.ndarray:
        """Batch bi's uint8 ``[b, th, tw, 3]`` image buffer: the staging
        slot, or a new array."""
        return (self.staging.slot(bi, shape) if self.staging is not None
                else np.empty((b,) + shape + (3,), np.uint8))[:b]

    def _fill(self, bi: int, batch_idx, target_shape, imgs: np.ndarray) -> Dict:
        """Batch bi's samples, their images written into ``imgs``; returns
        the rest of the batch."""
        rng = np.random.default_rng(self.seed * 100003 + self.epoch + bi)
        samples = [self.ds.get_sample(int(j), rng, out=imgs[k], target_shape=target_shape)
                   for k, j in enumerate(batch_idx)]
        out = {k: np.stack([smp[k] for smp in samples])
               for k in ("gt_boxes", "gt_classes", "gt_mask")}
        out["paths"] = [smp["path"] for smp in samples]
        out["orig_shapes"] = [smp["orig_shape"] for smp in samples]
        out["img_shapes"] = [smp["img_shape"] for smp in samples]
        return out

    def load(self, bi: int, batch_idx, target_shape=None) -> Dict:
        imgs = self._buffer(bi, len(batch_idx), self._shape(target_shape))
        out = self._fill(bi, batch_idx, target_shape, imgs)
        out["imgs"] = imgs
        return out

    def __iter__(self):
        batches = ((bi, batch_idx, tgt)
                   for bi, (batch_idx, tgt) in enumerate(self._batch_plan()))
        if self.mode == "process" and self.num_workers > 1 and len(self):
            yield from self._iter_processes(list(batches))
            return
        if self.num_workers <= 1:
            for args in batches:
                yield self.load(*args)
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

    # ------------------------------------------------------ process mode

    def _slot_layout(self):
        """Byte offsets of one slot's ``imgs`` (uint8, flat), ``gt_boxes``,
        ``gt_classes`` (int32) and ``gt_mask``, and the slot's size, each
        part 64-byte aligned."""
        b, g = self.batch_size, self.ds.max_gt
        sizes = [b * self._img_capacity() * 3, b * g * 5 * 4, b * g * 4, b * g]
        offs = [0]
        for n in sizes:
            offs.append(offs[-1] + -(-n // 64) * 64)
        return offs[:-1], offs[-1]

    def _slot_views(self, buf, slot: int):
        b, g = self.batch_size, self.ds.max_gt
        (oi, ob, oc, om), size = self._slot_layout()
        base = slot * size
        return (np.frombuffer(buf, np.uint8, b * self._img_capacity() * 3, base + oi),
                np.frombuffer(buf, np.float32, b * g * 5, base + ob).reshape(b, g, 5),
                np.frombuffer(buf, np.int32, b * g, base + oc).reshape(b, g),
                np.frombuffer(buf, bool, b * g, base + om).reshape(b, g))

    def _iter_processes(self, batches):
        """``batches`` ``[(bi, indices, target)]`` loaded by forked
        workers into the slots of one anonymous shared map, yielded in
        order, each copied out of its slot before the slot takes the next
        batch. A worker that raises exits (its traceback goes to stderr)
        and the loader raises here."""
        ctx = mp.get_context("fork")
        nslots = min(max(PREFETCH, self.num_workers), len(batches))
        _, size = self._slot_layout()
        buf = mmap.mmap(-1, nslots * size)  # MAP_SHARED: the forked workers write into it
        tasks = ctx.SimpleQueue()
        pipes = [ctx.Pipe(duplex=False) for _ in range(min(self.num_workers, nslots))]
        workers = [ctx.Process(target=_batch_worker, args=(self, buf, tasks, send), daemon=True)
                   for _, send in pipes]
        results = [recv for recv, _ in pipes]
        with contextlib.ExitStack() as stack:
            stack.callback(_stop_workers, workers, tasks)
            for w in workers:
                w.start()
            for slot in range(nslots):
                tasks.put((slot,) + batches[slot])
            ready, nxt = {}, nslots
            for bi, batch_idx, tgt in batches:
                while bi not in ready:
                    done = mp_connection.wait(results + [w.sentinel for w in workers])
                    dead = [w for w in workers if w.sentinel in done]
                    if dead:
                        raise RuntimeError(f"a loader worker process died (exit code "
                                           f"{dead[0].exitcode}); see its traceback above")
                    for conn in done:
                        got_bi, slot, meta = conn.recv()
                        ready[got_bi] = slot, meta
                slot, meta = ready.pop(bi)
                n, shape = len(batch_idx), self._shape(tgt)
                imgs_f, boxes, classes, mask = self._slot_views(buf, slot)
                imgs = self._buffer(bi, n, shape)
                np.copyto(imgs, imgs_f[: imgs.size].reshape(imgs.shape))
                out = dict(meta, imgs=imgs, gt_boxes=boxes[:n].copy(),
                           gt_classes=classes[:n].copy(), gt_mask=mask[:n].copy())
                del imgs_f, boxes, classes, mask
                if nxt < len(batches):
                    tasks.put((slot,) + batches[nxt])
                    nxt += 1
                yield out


def _stop_workers(workers, tasks) -> None:
    for _ in workers:
        tasks.put(None)
    for w in workers:
        w.join(timeout=5)
        if w.is_alive():
            w.terminate()


def _batch_worker(loader: BatchLoader, buf, tasks, results) -> None:
    """A forked loader worker: batches into shared-memory slots until the
    ``None`` task. Host work only: the training process's CUDA state is
    never touched here."""
    torch.set_num_threads(1)  # one worker, one core; no nested thread pools
    for slot, bi, batch_idx, tgt in iter(tasks.get, None):
        imgs_f, boxes, classes, mask = loader._slot_views(buf, slot)
        n, shape = len(batch_idx), loader._shape(tgt)
        imgs = imgs_f[: n * shape[0] * shape[1] * 3].reshape((n,) + shape + (3,))
        out = loader._fill(bi, batch_idx, tgt, imgs)
        boxes[:n] = out.pop("gt_boxes")
        classes[:n] = out.pop("gt_classes")
        mask[:n] = out.pop("gt_mask")
        results.send((bi, slot, out))
