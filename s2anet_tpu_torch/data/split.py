"""DOTA chip splitting: the port of ``s2anet_tpu/data/split.py``.

A ``subsize`` x ``subsize`` window slides with stride ``subsize - gap``
(1024 / gap 200 -> stride 824), the last window of a row or column is
pulled back to the image's edge, and windows past a small image are
zero-padded. Chip names follow ``name__rate__left___up`` so that
:mod:`.merge` can invert the tiling. At ``rate != 1`` the image is first
rescaled by :func:`.augment.resize_bicubic` (cv2's ``INTER_CUBIC``, within
one level) and the polygons with it.

Each object's polygon is clipped to each window (:func:`clip_objects_to_window`,
on :mod:`..ops.polyiou`'s clipping): a polygon wholly inside passes
through; a cut one is kept where more than ``thresh`` of its area is
inside, its clip's duplicate and collinear vertices dropped, a 5-vertex
clip repaired to 4 by merging its shortest edge, and the vertices rotated
to the original's order. :func:`split_dataset` splits a DOTA-layout
directory (``images/``, ``labelTxt/``) with a process pool, reading images
with :mod:`.image` and writing chips as PNG (:func:`.synth.write_png`):
another ``ext`` raises, where the JAX splitter writes any format cv2 does.
"""

from __future__ import annotations

import re
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from ..ops.polyiou import _ensure_ccw, clip_polygon, polygon_area
from .augment import resize_bicubic
from .image import imread
from .synth import write_png

SPLIT_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".bmp")  # the JAX splitter's inputs

DOTA_CLASSES = (
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
    "harbor", "swimming-pool", "helicopter",
)
# the strings Python's float() reads (no underscores in DOTA files)
_FLOAT_RE = re.compile(
    r"[+-]?((\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|inf(inity)?|nan)", re.IGNORECASE)


def parse_dota_label(path) -> List[Dict]:
    """Parse a DOTA labelTxt file -> list of {poly[8], name, difficult};
    header lines (``imagesource:``, ``gsd:``) and lines whose first eight
    fields are not numbers are skipped."""
    objs = []
    for line in Path(path).read_text().splitlines():
        parts = line.strip().split()
        if len(parts) < 9:
            continue
        if not all(_FLOAT_RE.fullmatch(v) for v in parts[:8]):
            continue
        poly = [float(v) for v in parts[:8]]
        difficult = int(parts[9]) if len(parts) > 9 and parts[9].isdigit() else 0
        objs.append({"poly": np.array(poly), "name": parts[8],
                     "difficult": difficult})
    return objs


def _dedupe_poly(pts: np.ndarray, tol: float = 1e-7) -> np.ndarray:
    """Drop duplicate and collinear vertices (shapely's minimal rings)."""
    if len(pts) == 0:
        return pts
    out = []
    n = len(pts)
    for i in range(n):
        if not out or np.linalg.norm(pts[i] - out[-1]) > tol:
            out.append(pts[i])
    if len(out) > 1 and np.linalg.norm(out[0] - out[-1]) <= tol:
        out.pop()
    pts = np.asarray(out)
    keep = []
    n = len(pts)
    for i in range(n):
        a, b, c = pts[i - 1], pts[i], pts[(i + 1) % n]
        cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        scale = max(np.linalg.norm(b - a) * np.linalg.norm(c - a), 1e-12)
        if abs(cross) / scale > 1e-7:
            keep.append(i)
    return pts[keep] if keep else pts[:0]


def _repair_poly5(poly: np.ndarray) -> np.ndarray:
    """5-vertex clip -> 4 vertices: the endpoints of the shortest edge merge
    at their midpoint."""
    dists = [np.linalg.norm(poly[(i + 1) % 5] - poly[i]) for i in range(5)]
    pos = int(np.argmin(dists))
    out = []
    i = 0
    while i < 5:
        if i == pos:
            out.append((poly[i] + poly[(i + 1) % 5]) / 2)
            i += 2
        else:
            out.append(poly[i])
            i += 1
    return np.asarray(out[:4])


def _best_point_order(poly: np.ndarray, ref_poly: np.ndarray) -> np.ndarray:
    """The cyclic rotation of ``poly`` nearest ``ref_poly`` (the summed
    vertex distances)."""
    best, best_d = poly, np.inf
    for k in range(4):
        cand = np.roll(poly, -k, axis=0)
        d = np.linalg.norm(cand - ref_poly, axis=1).sum()
        if d < best_d:
            best, best_d = cand, d
    return best


def clip_objects_to_window(objects, left: float, up: float, subsize: int,
                           thresh: float = 0.5) -> List[Dict]:
    """The objects of one window, their polygons clipped to it and made
    window-local (see the module's docstring)."""
    win = np.array([[left, up], [left + subsize, up], [left + subsize, up + subsize],
                    [left, up + subsize]], dtype=np.float64)
    out = []
    for obj in objects:
        poly = np.asarray(obj["poly"], dtype=np.float64).reshape(4, 2)
        area = abs(polygon_area(_ensure_ccw(poly)))
        if area <= 0:
            continue
        inter = clip_polygon(poly, win)
        if len(inter) < 3:
            continue
        frac = abs(polygon_area(inter)) / area
        if frac >= 1.0 - 1e-9:
            out.append({**obj, "poly": (poly - np.array([left, up])).reshape(8).copy()})
            continue
        if frac <= thresh:
            continue
        cut = _dedupe_poly(_ensure_ccw(inter))
        if len(cut) < 4 or len(cut) > 5:
            continue
        if len(cut) == 5:
            cut = _repair_poly5(cut)
        cut = _best_point_order(cut, poly) - np.array([left, up])
        cut = np.clip(cut, 1.0, float(subsize))
        out.append({**obj, "poly": cut.reshape(8).copy()})
    return out


def window_origins(h: int, w: int, subsize: int, slide: int):
    """Top-left corners of the sliding windows covering an (h, w) image."""
    lefts = list(range(0, max(w - subsize, 0) + 1, slide))
    if lefts[-1] + subsize < w:
        lefts.append(w - subsize)
    ups = list(range(0, max(h - subsize, 0) + 1, slide))
    if ups[-1] + subsize < h:
        ups.append(h - subsize)
    # images smaller than subsize still get one (0, 0) window
    return [(l, u) for u in ups for l in lefts]


def split_image(img: np.ndarray, objects, name: str, subsize: int = 1024,
                gap: int = 200, rate: float = 1.0, thresh: float = 0.5,
                pad: bool = True) -> Iterator[Tuple[str, np.ndarray, List[Dict]]]:
    """Yield ``(chip_name, chip, chip_objects)`` covering the image, row by
    row (``objects``: ``parse_dota_label``'s dicts, or [])."""
    if rate != 1.0:
        img = resize_bicubic(img, rate)
        objects = [{**o, "poly": np.asarray(o["poly"]) * rate} for o in objects]
    h, w = img.shape[:2]
    for left, up in window_origins(h, w, subsize, subsize - gap):
        chip = img[up: up + subsize, left: left + subsize]
        if pad and (chip.shape[0] < subsize or chip.shape[1] < subsize):
            padded = np.zeros((subsize, subsize) + chip.shape[2:], chip.dtype)
            padded[: chip.shape[0], : chip.shape[1]] = chip
            chip = padded
        yield (f"{name}__{rate}__{left}___{up}", chip,
               clip_objects_to_window(objects, left, up, subsize, thresh))


def _split_one(args) -> int:
    (img_path, label_path, out_images, out_labels, subsize, gap, rate, thresh, ext) = args
    img = imread(img_path)
    if img is None:
        return 0
    objects = parse_dota_label(label_path) if label_path else []
    n = 0
    for chip_name, chip, objs in split_image(img, objects, Path(img_path).stem, subsize,
                                             gap, rate, thresh):
        write_png(Path(out_images) / (chip_name + ext), chip[:, :, ::-1])
        lines = [" ".join(f"{v}" for v in o["poly"]) + f" {o['name']} {o['difficult']}"
                 for o in objs]
        (Path(out_labels) / (chip_name + ".txt")).write_text("\n".join(lines))
        n += 1
    return n


def split_dataset(image_dir, label_dir, out_dir, subsize: int = 1024, gap: int = 200,
                  rates: Sequence[float] = (1.0,), thresh: float = 0.5,
                  num_workers: int = 8, ext: str = ".png") -> int:
    """Split a DOTA-layout dataset into ``out_dir/images`` (PNG chips) and
    ``out_dir/labelTxt``; returns the number of chips written. Each image
    at each rate is one task of a pool of ``num_workers`` processes (one:
    in this process); an image that is not an image file is skipped."""
    if ext != ".png":
        raise ValueError(f"ext {ext!r}: the port writes PNG chips only")
    out_images = Path(out_dir) / "images"
    out_labels = Path(out_dir) / "labelTxt"
    out_images.mkdir(parents=True, exist_ok=True)
    out_labels.mkdir(parents=True, exist_ok=True)
    tasks = []
    for img_path in sorted(Path(image_dir).iterdir()):
        if img_path.suffix.lower() not in SPLIT_EXTS:
            continue
        lbl = Path(label_dir) / (img_path.stem + ".txt") if label_dir else None
        if lbl is not None and not lbl.exists():
            lbl = None
        tasks.extend((img_path, lbl, out_images, out_labels, subsize, gap, rate, thresh, ext)
                     for rate in rates)
    if num_workers > 1:
        with ProcessPoolExecutor(num_workers) as pool:
            return sum(pool.map(_split_one, tasks))
    return sum(_split_one(t) for t in tasks)
