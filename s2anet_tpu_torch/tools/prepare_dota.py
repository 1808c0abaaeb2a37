"""DOTA preparation in one command: ``python -m
s2anet_tpu_torch.tools.prepare_dota --src DOTA --out OUT [--rates 0.5 1.0]``.

The port of ``tools/prepare_dota.py``: for each of ``train`` and ``val``
under ``--src`` (``<split>/images``, ``<split>/labelTxt``), split every
image at every rate into ``--subsize`` chips overlapping by ``--gap``
(:func:`..data.split.split_dataset`, PNG chips), convert the chips' labels
to YOLO-rotated ``labels/`` (:func:`.convert_dota_to_yolo.convert`; chips
without an object keep an empty label file in ``val`` only) and write the
chip list ``OUT/<split>_split.txt``, which ``python -m
s2anet_tpu_torch.train`` / ``val`` take as ``--data-root``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..data.split import split_dataset
from .convert_dota_to_yolo import convert


def prepare(src_root, out_root, subsize=1024, gap=200, rates=(1.0,),
            splits=("train", "val"), workers=8):
    src_root = Path(src_root)
    out_root = Path(out_root)
    for split in splits:
        img_dir = src_root / split / "images"
        lbl_dir = src_root / split / "labelTxt"
        split_out = out_root / f"{split}_split"
        n = split_dataset(img_dir, lbl_dir if lbl_dir.exists() else None, split_out,
                          subsize=subsize, gap=gap, rates=rates, num_workers=workers)
        print(f"{split}: {n} chips")
        convert(split_out / "images", split_out / "labelTxt", split_out / "labels",
                keep_empty=(split != "train"))
        imgs = sorted((split_out / "images").iterdir())
        (out_root / f"{split}_split.txt").write_text("\n".join(str(p) for p in imgs))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", required=True, help="DOTA root with {train,val}/{images,labelTxt}")
    p.add_argument("--out", required=True)
    p.add_argument("--subsize", type=int, default=1024)
    p.add_argument("--gap", type=int, default=200)
    p.add_argument("--rates", type=float, nargs="+", default=[1.0])
    p.add_argument("--workers", type=int, default=8)
    a = p.parse_args(argv)
    prepare(a.src, a.out, a.subsize, a.gap, tuple(a.rates), workers=a.workers)


if __name__ == "__main__":
    main()
