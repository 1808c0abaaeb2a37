"""The synthetic acceptance dataset, without cv2:
``python -m s2anet_tpu_torch.data.synth``.

The port of ``tools/gen_synth.py``, with its flags (``--out``,
``--n-train``, ``--n-val``, ``--img-size``, ``--num-classes``,
``--max-boxes``, ``--min-boxes``, ``--dense``, ``--seed``) and its random
draws in its order, so the label files are the same bytes. Chips hold 1-3
class-coloured rotated rectangles on dark noise (``--dense``: 100-140
small, overlapping ones, 8 classes)::

    <out>/train/images/*.png (+ BGR .npy sidecars)   <out>/train/labels/*.txt
    <out>/val/images/*.png   (+ BGR .npy sidecars)   <out>/val/labels/*.txt

one label line per box: ``cls x1 y1 x2 y2 x3 y3 x4 y4`` (normalized
corners). The rectangles are filled by :func:`fill_convex` (pixels whose
centre lies inside or on the polygon with rounded vertices), where the
JAX script calls ``cv2.fillPoly``: the two differ only on polygon edges
(tests/test_torch_port_synth.py states the share). PNGs are written by
:func:`write_png` (zlib); the BGR ``.npy`` sidecar written after each is
what the port's loader reads.

    python -m s2anet_tpu_torch.data.synth --out runs/synth_accept
    python -m s2anet_tpu_torch.train --config configs/synth_accept.yaml \\
        --data-root runs/synth_accept/train/images \\
        --val-root runs/synth_accept/val/images --save-dir runs/accept/torch
"""

from __future__ import annotations

import argparse
import struct
import zlib
from pathlib import Path

import numpy as np

# fill colours per class (BGR), bright against the dark noise
CLASS_COLORS = [
    (60, 60, 230), (80, 220, 80), (230, 160, 60), (60, 220, 220), (220, 80, 220),
    (230, 230, 230), (60, 140, 250), (200, 230, 140), (120, 90, 250), (250, 220, 200),
]


def write_png(path, rgb: np.ndarray, level: int = 1, filters=0) -> None:
    """An 8-bit RGB PNG of ``[H, W, 3]`` uint8, one zlib stream.
    ``filters``: the PNG row filter (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth) of every row, or a sequence of one a row."""
    h, w, _ = rgb.shape
    types = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    if types.any():
        x = np.ascontiguousarray(rgb).reshape(h, w * 3).astype(np.int16)
        left = np.pad(x, ((0, 0), (3, 0)))[:, :-3]
        up = np.pad(x, ((1, 0), (0, 0)))[:-1]
        up_left = np.pad(up, ((0, 0), (3, 0)))[:, :-3]
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
        rows = ((x - preds[types, np.arange(h)]) & 0xFF).astype(np.uint8)
    else:  # filter None on every row: the bytes as they are
        rows = np.ascontiguousarray(rgb, np.uint8).reshape(h, w * 3)
    raw = np.concatenate([types.astype(np.uint8)[:, None], rows], 1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n"
                           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                           + chunk(b"IEND", b""))


def rbox_corners(cx, cy, w, h, th):
    """[4, 2] polygon corners of a rotated rect, consistent ring order."""
    c, s = np.cos(th), np.sin(th)
    dx, dy = w / 2.0, h / 2.0
    pts = np.array([[-dx, -dy], [dx, -dy], [dx, dy], [-dx, dy]], np.float64)
    rot = np.array([[c, -s], [s, c]])
    return pts @ rot.T + [cx, cy]


def fill_convex(img: np.ndarray, pts: np.ndarray, color) -> None:
    """Paint the pixels of ``img`` whose integer centre is inside or on the
    convex polygon ``pts [n, 2]`` (integer x, y)."""
    h, w = img.shape[:2]
    x0, y0 = np.maximum(pts.min(0), 0)
    x1, y1 = np.minimum(pts.max(0), [w - 1, h - 1])
    if x1 < x0 or y1 < y0:
        return
    yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    a, b = pts, np.roll(pts, -1, 0)
    cross = ((b[:, 0] - a[:, 0])[:, None, None] * (yy - a[:, 1, None, None])
             - (b[:, 1] - a[:, 1])[:, None, None] * (xx - a[:, 0, None, None]))
    inside = (cross >= 0).all(0) | (cross <= 0).all(0)
    img[y0:y1 + 1, x0:x1 + 1][inside] = color


def synth_image(rng, size, num_classes, max_boxes, min_boxes=1,
                box_scale=(0.15, 0.38), crowd=False):
    """One chip (BGR) and its label lines: ``tools/gen_synth.py``'s draws."""
    img = rng.integers(0, 50, (size, size, 3)).astype(np.uint8)
    n = int(rng.integers(min_boxes, max_boxes + 1))
    lines = []
    centers = []
    sep = 0.35 if crowd else 0.62
    for _ in range(n):
        for _attempt in range(40):
            w = rng.uniform(*box_scale) * size
            h = rng.uniform(0.35, 0.8) * w
            margin = 0.6 * np.hypot(w, h)
            if size - 2 * margin <= 1:
                continue
            cx, cy = rng.uniform(margin, size - margin, 2)
            if all(np.hypot(cx - x, cy - y) > sep * (np.hypot(w, h) + d)
                   for x, y, d in centers):
                break
        else:
            continue
        th = rng.uniform(-np.pi / 2, np.pi / 2)
        cls = int(rng.integers(0, num_classes))
        corners = rbox_corners(cx, cy, w, h, th)
        fill_convex(img, np.round(corners).astype(np.int64),
                    CLASS_COLORS[cls % len(CLASS_COLORS)])
        centers.append((cx, cy, np.hypot(w, h)))
        coords = " ".join(f"{v / size:.6f}" for v in corners.reshape(-1))
        lines.append(f"{cls} {coords}")
    return img, lines


def write_split(root: Path, n: int, rng, size, num_classes, max_boxes,
                min_boxes=1, box_scale=(0.15, 0.38), crowd=False):
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img, lines = synth_image(rng, size, num_classes, max_boxes,
                                 min_boxes, box_scale, crowd)
        png = root / "images" / f"im{i:05d}.png"
        write_png(png, img[:, :, ::-1])
        np.save(png.with_suffix(".npy"), img)  # BGR, newer than the PNG
        (root / "labels" / f"im{i:05d}.txt").write_text("\n".join(lines) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="runs/synth_accept")
    p.add_argument("--n-train", type=int, default=800)
    p.add_argument("--n-val", type=int, default=160)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--max-boxes", type=int, default=3)
    p.add_argument("--min-boxes", type=int, default=1)
    p.add_argument("--dense", action="store_true",
                   help="dense-scene preset (configs/synth_accept_dense.yaml): 100-140 "
                        "small overlapping boxes a chip, 8 classes")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.dense:
        args.num_classes = max(args.num_classes, 8)
        if args.max_boxes <= 3:  # untouched default -> dense preset counts
            args.min_boxes, args.max_boxes = 100, 140
        box_scale, crowd = (0.04, 0.11), True
    else:
        box_scale, crowd = (0.15, 0.38), False

    rng = np.random.default_rng(args.seed)
    out = Path(args.out)
    kw = dict(min_boxes=args.min_boxes, box_scale=box_scale, crowd=crowd)
    write_split(out / "train", args.n_train, rng, args.img_size,
                args.num_classes, args.max_boxes, **kw)
    write_split(out / "val", args.n_val, rng, args.img_size,
                args.num_classes, args.max_boxes, **kw)
    print(f"wrote {args.n_train} train + {args.n_val} val chips "
          f"({args.img_size}^2, {args.num_classes} classes, "
          f"{args.min_boxes}-{args.max_boxes} boxes) under {out}")


if __name__ == "__main__":
    main()
