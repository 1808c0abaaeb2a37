"""DOTA ``labelTxt`` -> YOLO-rotated labels: ``python -m
s2anet_tpu_torch.tools.convert_dota_to_yolo``.

The port of ``tools/convert_dota_to_yolo.py``, with its flags and output:
one ``cls x1 y1 x2 y2 x3 y3 x4 y4`` line per instance, the polygon divided
by the image's width and height and clipped to [0, 1]; instances above
``--max-difficult`` and of unknown classes are dropped; an image left
without a label gets no label file unless ``--keep-empty`` (and is moved
to ``--empty-dir`` where one is given). The image size comes from the PNG
or BMP header (:func:`..data.image.read_shape`), not from decoding; a file
that is not an image is skipped.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from ..data.image import read_shape
from ..data.split import DOTA_CLASSES, SPLIT_EXTS, parse_dota_label


def convert(image_dir, label_dir, out_label_dir, class_names=DOTA_CLASSES,
            max_difficult: int = 0, keep_empty: bool = False, empty_dir: str = ""):
    """Convert every image's label file; returns ``(images written, objects,
    images left empty)``."""
    out = Path(out_label_dir)
    out.mkdir(parents=True, exist_ok=True)
    name_to_id = {n: i for i, n in enumerate(class_names)}
    n_imgs = n_objs = n_empty = 0
    for img_path in sorted(Path(image_dir).iterdir()):
        if img_path.suffix.lower() not in SPLIT_EXTS:
            continue
        lbl = Path(label_dir) / (img_path.stem + ".txt")
        shape = read_shape(img_path)
        if shape is None:
            continue
        h, w = shape
        lines = []
        for obj in (parse_dota_label(lbl) if lbl.exists() else []):
            if obj["difficult"] > max_difficult:
                continue
            cid = name_to_id.get(obj["name"])
            if cid is None:
                continue
            poly = obj["poly"].astype(float).copy()
            poly[0::2] /= w
            poly[1::2] /= h
            poly = poly.clip(0.0, 1.0)
            lines.append(f"{cid} " + " ".join(f"{v:.6f}" for v in poly))
            n_objs += 1
        if lines or keep_empty:
            (out / (img_path.stem + ".txt")).write_text("\n".join(lines))
            n_imgs += 1
        else:
            n_empty += 1
            if empty_dir:
                Path(empty_dir).mkdir(parents=True, exist_ok=True)
                shutil.move(str(img_path), str(Path(empty_dir) / img_path.name))
    return n_imgs, n_objs, n_empty


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image-dir", required=True)
    p.add_argument("--label-dir", required=True)
    p.add_argument("--out-label-dir", required=True)
    p.add_argument("--max-difficult", type=int, default=0)
    p.add_argument("--keep-empty", action="store_true")
    p.add_argument("--empty-dir", default="")
    a = p.parse_args(argv)
    n_imgs, n_objs, n_empty = convert(a.image_dir, a.label_dir, a.out_label_dir,
                                      max_difficult=a.max_difficult,
                                      keep_empty=a.keep_empty, empty_dir=a.empty_dir)
    print(f"converted {n_imgs} images / {n_objs} objects; {n_empty} empty")


if __name__ == "__main__":
    main()
