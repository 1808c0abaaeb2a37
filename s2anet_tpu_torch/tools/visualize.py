"""Draw ground-truth labels and detections on chips: ``python -m
s2anet_tpu_torch.tools.visualize --data-root DIR``.

The counterpart of the repository's ``tools/visualize.py``, with its flags
and ``--device``. For the first ``--num`` images of ``--data-root`` (an
images directory or a list file, read by :class:`..data.dota.DotaDataset`
at ``--img-size``, letterboxed and unaugmented) it draws the labels' rotated
boxes and, given ``--weights`` (anything :func:`..predict.load_state_dict`
reads: EMA weights of a training checkpoint), the detections scoring at
least ``--conf`` (:class:`..predict.S2ANetPredictor`, bf16, BatchNorm
folded; decode and NMS at the model's defaults), each with its class name
and score, with :func:`..utils.plots.draw_rboxes`, and writes
``<out-dir>/<name>.png``. PNG where the JAX tool writes JPEG: the card's
machine has no JPEG encoder.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..config import NAMES_PRESETS, ModelConfig
from ..data.dota import DotaDataset
from ..data.split import DOTA_CLASSES
from ..data.synth import write_png
from ..predict import S2ANetPredictor
from ..utils.plots import draw_rboxes


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-root", required=True, help="images dir or list txt")
    p.add_argument("--out-dir", default="runs/visual")
    p.add_argument("--weights", default="", help="optional weights to draw detections")
    p.add_argument("--num", type=int, default=20)
    p.add_argument("--img-size", type=int, default=1024)
    p.add_argument("--conf", type=float, default=0.3)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--num-classes", type=int, default=15)
    p.add_argument("--names", default="dota",
                   help="class preset (dota, dota-v1.5, dota-v2.0, hrsc); numbers "
                        "where its length is not --num-classes")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list:
    a = parse_opt(argv)
    out_dir = Path(a.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    names = NAMES_PRESETS.get(a.names.lower(), DOTA_CLASSES)
    if len(names) != a.num_classes:
        names = [str(i) for i in range(a.num_classes)]
    ds = DotaDataset(a.data_root, img_size=a.img_size, augment=False)
    pred = None
    if a.weights:
        pred = S2ANetPredictor(ModelConfig(backbone=a.backbone, num_classes=a.num_classes),
                               a.weights, a.device)
    written = []
    for i in range(min(a.num, len(ds))):
        s = ds.get_sample(i)
        m = s["gt_mask"]
        vis = draw_rboxes(s["imgs"][:, :, ::-1], s["gt_boxes"][m], s["gt_classes"][m],
                          names=names)
        if pred is not None:
            det_boxes, det_labels, det_valid = (t[0].cpu().numpy()
                                                for t in pred.predict(s["imgs"][None]))
            keep = det_valid & (det_boxes[:, 5] >= a.conf)
            vis = draw_rboxes(vis, det_boxes[keep][:, :5], det_labels[keep],
                              det_boxes[keep][:, 5], names=names)
        path = out_dir / f"{Path(s['path']).stem}.png"
        write_png(path, np.ascontiguousarray(vis[:, :, ::-1]))
        written.append(path)
    print(f"wrote {len(written)} visualizations to {out_dir}")
    return written


if __name__ == "__main__":
    main()
