"""Evaluate S2ANet on DOTA-format chips: ``python -m s2anet_tpu_torch.val``.

The PyTorch/CUDA counterpart of the repository's ``val.py``: batched
detection on the card (forward, decode and rotated NMS through the port's
kernels), then either chip-level mAP against the chips' YOLO labels (the
default) or, with ``--no-map-split``, a cross-chip merge into full images
scored against the DOTA ``labelTxt`` files of ``--gt-dir``. Prints one
``<class> AP50 <ap>`` line per class, an ``mAP50`` line, and ends with a
JSON line ``{"map50", "precision", "recall", "images_per_sec"}``.

Data: ``--data-root`` is an ``images/`` directory (labels in the sibling
``labels/``) or a txt list of image paths; each image is read from its BGR
``.npy`` sidecar or, with ``--cache packed``, from the packed shard
``images.pack.bin`` beside the first image (:mod:`.data.dota`). Weights: ``--weights``
takes an ``.npz`` of JAX variables, a port ``state_dict`` (the trainer's
``weights/deploy``) or a training checkpoint (``weights/last``, ``best``,
``epochN``: its EMA weights, or its model's with ``--no-ema``); with none
they are random from ``--seed``. ``--config`` reads a YAML config
(``configs/*.yaml``, or a run's ``config.yaml``); a flag that is typed
replaces its value. The compute type is ``--dtype`` when typed, else the
config's ``train.dtype`` (bfloat16 by default), as in the JAX runner.

``--rect`` (or ``eval.rect`` in the config) evaluates in rect batches:
images ordered by aspect ratio, each batch letterboxed to its own shape
rounded up to ``eval.rect_stride`` (32), for datasets of non-square
images such as HRSC2016 (``configs/hrsc_r50.yaml``). cuDNN autotunes
its convolutions once for each new batch shape.

``--quant int8`` serves through int8 post-training quantisation: BatchNorm
folded, the activation ranges calibrated on the first
``quant_calib_batches`` (4) batches, then the convs of ``--quant-scope``
(comma-separated groups of backbone, neck, head_stacks, orconv, heads;
default backbone,neck,head_stacks) run through the int8 kernels. A group
that does not exist fails before anything is loaded; calibration runs on
square batches, also under ``--rect``. The PR-curve plot of ``val.py`` is
not offered.
"""

from __future__ import annotations

import argparse
import json

import torch

from .config import Config, load_config, prune_overrides
from .data.dota import CACHE_MODES
from .eval.runner import evaluate_on_chips
from .ops.quant import parse_scope
from .predict import DTYPES, S2ANetPredictor


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", default="",
                   help=".npz of JAX variables or .pt port state_dict; "
                        "none = random weights from --seed")
    p.add_argument("--data-root", required=True, help="val images dir or list txt")
    p.add_argument("--config", default="", help="yaml config path")
    # config-mirroring flags default to None: the config's value (else the
    # dataclass default) applies unless the flag is typed
    p.add_argument("--cache", default=None, choices=CACHE_MODES,
                   help="image source: '' = the BGR .npy sidecar beside each image "
                        "(else PIL), packed = the packed shard images.pack.bin")
    p.add_argument("--gt-dir", default=None, help="full-image DOTA labelTxt dir (merge mode)")
    p.add_argument("--backbone", default=None, help="default resnet50")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None, help="default 16")
    p.add_argument("--img-size", type=int, default=None, help="default 1024")
    p.add_argument("--conf-thres", type=float, default=None,
                   help="score threshold (default: ModelConfig.score_thr, 0.05)")
    p.add_argument("--iou-thres", type=float, default=None, help="NMS threshold")
    p.add_argument("--no-map-split", action="store_true",
                   help="merge chips to full images before eval")
    p.add_argument("--no-ema", action="store_true",
                   help="a training checkpoint's model weights, not its EMA")
    p.add_argument("--rect", action="store_true",
                   help="shape-ordered rect batches, each letterboxed to its own shape "
                        "(non-square datasets)")
    p.add_argument("--save-dir", default="", help="dump per-class DOTA-format result txts")
    p.add_argument("--task", type=int, default=None, choices=[1, 2],
                   help="1 = oriented boxes (Task1, default), 2 = horizontal (Task2)")
    p.add_argument("--names", default="",
                   help="class preset: dota | dota-v1.5 | dota-v2.0 | hrsc")
    p.add_argument("--use-07-metric", type=int, choices=[0, 1], default=None,
                   help="1 = 11-point VOC-07 AP (default), 0 = area under the curve")
    p.add_argument("--quant", default=None, choices=["none", "int8"],
                   help="int8 post-training quantisation for inference (calibrates "
                        "on the first val batches)")
    p.add_argument("--quant-scope", default=None,
                   help="comma-separated module groups to quantise "
                        "(backbone,neck,head_stacks,orconv,heads); default "
                        "backbone,neck,head_stacks")
    p.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                   help="compute type (default: the config's train.dtype, bfloat16)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def make_config(opt) -> Config:
    overrides = prune_overrides({
        "model": {"backbone": opt.backbone, "num_classes": opt.num_classes,
                  "score_thr": opt.conf_thres, "nms_iou_thr": opt.iou_thres,
                  "quant": opt.quant,
                  "quant_scope": parse_scope(opt.quant_scope) if opt.quant_scope else None},
        "data": {"root": opt.data_root, "val_list": opt.data_root, "img_size": opt.img_size,
                 "val_gt_dir": opt.gt_dir, "cache": opt.cache, "names": opt.names or None},
        "train": {"dtype": opt.dtype},
        "eval": {"batch_size": opt.batch_size, "task": opt.task,
                 "is_map_split": False if opt.no_map_split else None,
                 "rect": True if opt.rect else None,
                 "use_07_metric": (None if opt.use_07_metric is None
                                   else bool(opt.use_07_metric))},
    })
    cfg = load_config(opt.config or None, overrides)
    parse_scope(cfg.model.quant_scope)  # a config's typo, too, before any loading
    if cfg.train.dtype not in DTYPES:
        raise SystemExit(f"train.dtype {cfg.train.dtype!r}: one of {sorted(DTYPES)}")
    if not cfg.eval.is_map_split and not cfg.data.val_gt_dir:
        raise SystemExit("--no-map-split scores full images: give their labelTxt dir "
                         "with --gt-dir")
    return cfg


def main(argv=None) -> dict:
    opt = parse_opt(argv)
    cfg = make_config(opt)
    predictor = S2ANetPredictor(cfg.model, opt.weights, opt.device,
                                DTYPES[cfg.train.dtype], opt.seed, use_ema=not opt.no_ema)
    # fixed shapes (a few under rect): autotune the convs once per shape
    torch.backends.cudnn.benchmark = True
    out = evaluate_on_chips(predictor, cfg, verbose=True,
                            save_dir=opt.save_dir or None)
    print(json.dumps({"map50": out["map50"], "precision": out["mp"],
                      "recall": out["mr"], "images_per_sec": out["images_per_sec"]}))
    return out


if __name__ == "__main__":
    main()
