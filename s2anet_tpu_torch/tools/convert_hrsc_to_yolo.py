"""HRSC2016 annotations -> the YOLO-rotated layout: ``python -m
s2anet_tpu_torch.tools.convert_hrsc_to_yolo --hrsc-root ROOT --out OUT``.

The port of ``tools/convert_hrsc_to_yolo.py``, with its flags and output::

  <ROOT>/AllImages/<id>.bmp ...   <ROOT>/Annotations/<id>.xml ...
  <ROOT>/ImageSets/{trainval,train,val,test}.txt   (optional)
  ->  <OUT>/images/<id>.<ext>  (symlinked, or copied with --copy-images)
      <OUT>/labels/<id>.txt    "0 x1 y1 x2 y2 x3 y3 x4 y4" normalized
      <OUT>/train.txt, val.txt image lists (where the ImageSets exist)

Boxes come from :func:`..eval.hrsc.parse_hrsc_xml`; difficult objects are
dropped unless ``--keep-difficult``, and so are boxes reaching more than
1% past the frame. The image size is the XML's ``Img_SizeWidth`` /
``Img_SizeHeight``, else the image's header
(:func:`..data.image.read_shape`). Where the JAX script copies an image
whose symlink fails, this one raises.
"""

from __future__ import annotations

import argparse
import shutil
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from ..data.image import read_shape
from ..eval.hrsc import parse_hrsc_xml

IMG_EXTS = (".bmp", ".jpg", ".jpeg", ".png", ".tif")


def _image_size(root) -> tuple:
    w = root.find("Img_SizeWidth")
    h = root.find("Img_SizeHeight")
    if w is not None and h is not None:
        return int(w.text), int(h.text)
    return 0, 0


def convert_one(xml_path: Path, img_path: Path, out_images: Path, out_labels: Path,
                keep_difficult: bool, link_images: bool) -> int:
    """One image's label file (and its image in ``out_images``); returns
    the objects written."""
    w0, h0 = _image_size(ET.parse(str(xml_path)).getroot())
    if not (w0 and h0):
        shape = read_shape(img_path)
        if shape is None:
            raise ValueError(f"{img_path}: not an image, and {xml_path} gives no size")
        h0, w0 = shape
    rows = []
    for obj in parse_hrsc_xml(xml_path):
        if obj["difficult"] and not keep_difficult:
            continue
        poly = np.asarray(obj["poly"], np.float64).copy()
        poly[0::2] /= w0
        poly[1::2] /= h0
        if (poly < -0.01).any() or (poly > 1.01).any():
            continue  # degenerate / out-of-frame annotation
        poly = poly.clip(0.0, 1.0)
        rows.append("0 " + " ".join(f"{v:.6f}" for v in poly))
    dst_img = out_images / img_path.name
    if not dst_img.exists():
        if link_images:
            dst_img.symlink_to(img_path.resolve())
        else:
            shutil.copy2(img_path, dst_img)
    (out_labels / f"{img_path.stem}.txt").write_text("\n".join(rows) + ("\n" if rows else ""))
    return len(rows)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hrsc-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--keep-difficult", action="store_true")
    p.add_argument("--copy-images", action="store_true", help="copy instead of symlink")
    opt = p.parse_args(argv)

    root = Path(opt.hrsc_root)
    images, annos = root / "AllImages", root / "Annotations"
    out = Path(opt.out)
    out_images, out_labels = out / "images", out / "labels"
    out_images.mkdir(parents=True, exist_ok=True)
    out_labels.mkdir(parents=True, exist_ok=True)

    n_img = n_obj = 0
    by_id = {}
    for img in sorted(images.iterdir()):
        if img.suffix.lower() not in IMG_EXTS:
            continue
        xml = annos / f"{img.stem}.xml"
        if not xml.exists():
            continue
        n_obj += convert_one(xml, img, out_images, out_labels, opt.keep_difficult,
                             not opt.copy_images)
        by_id[img.stem] = out_images / img.name
        n_img += 1

    sets = root / "ImageSets"
    for split, out_name in (("trainval", "train.txt"), ("train", "train.txt"),
                            ("val", "val.txt"), ("test", "val.txt")):
        f = sets / f"{split}.txt"
        if f.exists():
            ids = [line.strip() for line in f.read_text().splitlines() if line.strip()]
            paths = [str(by_id[i]) for i in ids if i in by_id]
            (out / out_name).write_text("\n".join(paths) + "\n")
    print(f"converted {n_img} images / {n_obj} objects -> {out}")


if __name__ == "__main__":
    main()
