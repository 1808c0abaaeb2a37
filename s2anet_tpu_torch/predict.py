"""Serve S2ANet on chip-sized images: ``python -m s2anet_tpu_torch.predict``.

The PyTorch/CUDA counterpart of the repository's ``predict.py`` in chips
mode (``parallel/step.py::make_eval_step``): each chip is scaled by 1/255
and run through the detector, decode and multiclass rotated NMS in batches.
Per chip it writes ``<save-dir>/<name>.txt`` with one
``class score x1 y1 x2 y2 x3 y3 x4 y4`` line per detection, prints one
``<name>: N detections`` line, and ends with a JSON summary line.

Inputs: ``--source`` is a directory of ``.npy`` chips (``[H, W, 3]`` uint8
RGB) or ``--synthetic N`` makes N random chips from ``--seed``. Weights:
``--weights`` takes an ``.npz`` of JAX-layout variables
(:func:`.models.convert.save_jax_npz`) or a ``.pt`` port ``state_dict``;
with none, the weights are random from ``--seed``.

Not yet here: tiling and merging full-size images, and ``--mode spatial``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from .config import DOTA10_CLASSES, ModelConfig
from .models.convert import load_jax_npz, state_dict_from_jax
from .models.detector import S2ANet
from .models.fold import fold_bn
from .models.head import s2anet_get_bboxes
from .ops.rbox import rbox_to_poly

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_state_dict(path: str, arch: str):
    """A port ``state_dict`` from a ``.pt`` file or JAX variables ``.npz``."""
    if path.endswith(".npz"):
        return state_dict_from_jax(load_jax_npz(path), arch)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd) if isinstance(sd, dict) else sd


class S2ANetPredictor:
    """Load (or seed), fold and place the detector; ``predict`` runs
    forward + decode + NMS on a batch of chips."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), weights: str = "",
                 device: str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device")
        self.cfg = cfg
        self.dtype = dtype
        model = S2ANet(cfg.backbone, cfg.num_classes, tuple(cfg.strides),
                       align_offset_clamp=cfg.align_offset_clamp)
        if weights:
            model.load_state_dict(load_state_dict(weights, cfg.backbone))
        else:
            model.init_weights(torch.Generator().manual_seed(seed))
        model.eval()
        if cfg.fold_bn:
            fold_bn(model)
        model.to(self.device).cast(dtype)
        # NHWC convs: the AlignConv kernel then reads its input in place
        for p in model.parameters():
            if p.dim() == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
        self.model = model

    def post_kwargs(self):
        c = self.cfg
        return dict(score_thr=c.score_thr, iou_thr=c.nms_iou_thr,
                    max_before_nms_per_level=c.max_before_nms_per_level,
                    max_per_img=c.max_per_img, pre_nms_cap=c.pre_nms_cap)

    def to_input(self, imgs) -> torch.Tensor:
        """``[B, H, W, 3]`` uint8 RGB (numpy or tensor) -> ``[B, 3, H, W]``
        in the compute type, scaled by 1/255, channels-last on the device."""
        x = torch.as_tensor(imgs).to(self.device)
        x = (x.float() / 255.0).to(self.dtype)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    @torch.no_grad()
    def forward(self, x: torch.Tensor):
        """Raw head outputs of a prepared batch (see :meth:`to_input`)."""
        return self.model(x)

    @torch.no_grad()
    def predict(self, imgs, **overrides):
        """``(det_boxes [B,K,6], det_labels [B,K], det_valid [B,K])``;
        ``overrides`` replace decode/NMS settings (e.g. ``score_thr``)."""
        out = self.forward(self.to_input(imgs))
        return s2anet_get_bboxes(out, **{**self.post_kwargs(), **overrides})


def _chips(opt):
    if opt.synthetic:
        rng = np.random.default_rng(opt.seed)
        for i in range(opt.synthetic):
            yield f"synthetic_{i:04d}", rng.integers(
                0, 256, (opt.img_size, opt.img_size, 3), dtype=np.uint8)
        return
    paths = sorted(Path(opt.source).glob("*.npy"))
    if not paths:
        raise SystemExit(f"no .npy chips under {opt.source}")
    for p in paths:
        chip = np.load(p)
        if chip.shape != (opt.img_size, opt.img_size, 3) or chip.dtype != np.uint8:
            raise SystemExit(f"{p}: want [{opt.img_size}, {opt.img_size}, 3] "
                             f"uint8, got {list(chip.shape)} {chip.dtype}")
        yield p.stem, chip


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--source", help="directory of [H,W,3] uint8 RGB .npy chips")
    src.add_argument("--synthetic", type=int, default=0,
                     help="make N random chips from --seed")
    p.add_argument("--weights", default="",
                   help=".npz of JAX variables or .pt port state_dict; "
                        "none = random weights from --seed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--num-classes", type=int, default=15)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--img-size", type=int, default=1024)
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bfloat16")
    p.add_argument("--device", default="cuda")
    p.add_argument("--conf", type=float, default=None,
                   help="score threshold (default: predict_score_thr, 0.3)")
    p.add_argument("--iou-thres", type=float, default=None)
    p.add_argument("--save-dir", default="runs/predict_torch")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    opt = parse_opt(argv)
    cfg = ModelConfig(backbone=opt.backbone, num_classes=opt.num_classes)
    cfg = dataclasses.replace(
        cfg,
        score_thr=opt.conf if opt.conf is not None else cfg.predict_score_thr,
        nms_iou_thr=opt.iou_thres if opt.iou_thres is not None else cfg.nms_iou_thr,
    )
    names = (DOTA10_CLASSES if cfg.num_classes == len(DOTA10_CLASSES)
             else [str(i) for i in range(cfg.num_classes)])
    predictor = S2ANetPredictor(cfg, opt.weights, opt.device,
                                _DTYPES[opt.dtype], opt.seed)
    torch.backends.cudnn.benchmark = True  # fixed shapes: autotune the convs
    save_dir = Path(opt.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)

    n_chips = n_dets = 0
    t0 = time.perf_counter()
    chips = _chips(opt)
    while True:
        group = [c for _, c in zip(range(opt.batch_size), chips)]
        if not group:
            break
        imgs = np.stack([c for _, c in group])
        if len(group) < opt.batch_size:  # pad to the fixed batch
            pad = np.zeros((opt.batch_size - len(group),) + imgs.shape[1:], np.uint8)
            imgs = np.concatenate([imgs, pad])
        det_boxes, det_labels, det_valid = predictor.predict(imgs)
        polys = rbox_to_poly(det_boxes[..., :5]).cpu().numpy()
        scores = det_boxes[..., 5].cpu().numpy()
        labels = det_labels.cpu().numpy()
        valid = det_valid.cpu().numpy()
        for k, (name, _) in enumerate(group):
            lines = [
                f"{names[c]} {s:.4f} " + " ".join(f"{v:.2f}" for v in poly)
                for c, s, poly in zip(labels[k][valid[k]], scores[k][valid[k]],
                                      polys[k][valid[k]])
            ]
            (save_dir / f"{name}.txt").write_text("".join(l + "\n" for l in lines))
            print(f"{name}: {len(lines)} detections")
            n_dets += len(lines)
        n_chips += len(group)
    summary = {"chips": n_chips, "detections": n_dets,
               "seconds": round(time.perf_counter() - t0, 3),
               "device": str(predictor.device), "save_dir": str(save_dir)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
