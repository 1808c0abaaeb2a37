"""Serve S2ANet on images of any size: ``python -m s2anet_tpu_torch.predict``.

The PyTorch/CUDA counterpart of the repository's ``predict.py`` in chips
mode (``--mode chips``, the default and for now the only mode): every
input is tiled into ``--img-size`` windows overlapping by ``--gap``
(:func:`.data.split.split_image`; an input no larger than one window is
one zero-padded window), the windows run in fixed batches through the
detector, decode and multiclass rotated NMS (each chip scaled by 1/255),
and each input's detections are shifted back and merged by cross-chip
polygon NMS at ``--iou-thres`` (:func:`.data.merge.merge_chip_detections`).
Per input it writes ``<save-dir>/<name>.txt`` with one
``class score x1 y1 x2 y2 x3 y3 x4 y4`` line per detection, prints one
``<name>: N detections`` line, and ends with a JSON summary line (model and
merge seconds apart).

Inputs: ``--source`` is a directory of ``.npy`` images (``[H, W, 3]``
uint8 **RGB**, any size) or ``--synthetic N`` makes N random chips of
``--img-size`` from ``--seed``. Weights: ``--weights`` takes an ``.npz`` of
JAX-layout variables (:func:`.models.convert.save_jax_npz`), a port
``state_dict`` (the trainer's ``weights/deploy``) or a training checkpoint
(``weights/last``, ``best``, ``epochN``: its EMA weights, or its model's
with ``--no-ema``); with none, the weights are random from ``--seed``.
``--config`` reads a YAML config: ``--backbone``, ``--num-classes``,
``--img-size``, ``--iou-thres`` and ``--names`` replace its values when
typed, ``--conf`` defaults to its ``model.predict_score_thr`` (0.3), and
the class names written are its names (``--names`` a preset).

Not yet here: ``--mode spatial`` (the whole image, sharded by height).
int8 serving (``ModelConfig.quant``) runs through ``python -m
s2anet_tpu_torch.val --quant int8``, which calibrates on its first
batches; like the repository's ``predict.py``, this CLI has no ``--quant``.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from . import native
from .config import ModelConfig, load_config, prune_overrides
from .data.merge import merge_chip_detections
from .data.split import split_image
from .eval.runner import BatchPipeline, detections_to_polys
from .models.convert import load_jax_npz, state_dict_from_jax
from .models.detector import S2ANet
from .models.fold import fold_bn
from .models.head import s2anet_get_bboxes
from .ops.quant import calibrate, parse_scope
from .train.step import scale_images

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_state_dict(path: str, arch: str, use_ema: bool = True):
    """A port ``state_dict`` from JAX variables (``.npz``) or a
    ``torch.save`` file: a deploy ``state_dict`` (``weights/deploy``), one
    under ``"state_dict"``, or a training checkpoint of
    :func:`.train.checkpoint.save_checkpoint` (``weights/last``, ``best``,
    ``epochN``), whose EMA weights are taken unless ``use_ema`` is False. A
    file with one set of weights serves for both."""
    if str(path).endswith(".npz"):
        return state_dict_from_jax(load_jax_npz(path), arch)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and {"model", "ema"} <= sd.keys():
        return sd["ema" if use_ema else "model"]
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    if not isinstance(sd, dict) or not all(torch.is_tensor(v) for v in sd.values()):
        keys = sorted(map(str, sd)) if isinstance(sd, dict) else type(sd).__name__
        raise ValueError(f"{path}: neither a state_dict nor a training checkpoint "
                         f"(model, ema, ...); it holds {keys}")
    return sd


class S2ANetPredictor:
    """Load (or seed), fold and place the detector; ``predict`` runs
    forward + decode + NMS on a batch of chips. ``weights`` is any file
    :func:`load_state_dict` reads (a training checkpoint: its EMA weights,
    or its model's with ``use_ema=False``).

    With ``cfg.quant == "int8"`` the convs of ``cfg.quant_scope`` (checked
    first) are set to calibrate before the cast, so their float32 weights
    stay; :meth:`calibrate` then records the activation ranges over the
    batches it is given and switches them to int8. Until then ``predict``
    raises."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), weights: str = "",
                 device: str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0, use_ema: bool = True):
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"quant {cfg.quant!r}: expected none | int8")
        self.scope = parse_scope(cfg.quant_scope)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device")
        self.cfg = cfg
        self.dtype = dtype
        model = S2ANet.from_config(cfg)
        if weights:
            model.load_state_dict(load_state_dict(weights, cfg.backbone, use_ema))
        else:
            model.init_weights(torch.Generator().manual_seed(seed))
        model.eval()
        if cfg.fold_bn:
            fold_bn(model)
        self.needs_calibration = cfg.quant == "int8"
        if self.needs_calibration:
            model.set_quant("calib", self.scope)
        self.model = model.to(self.device).cast(dtype).channels_last()

    @torch.no_grad()
    def calibrate(self, batches) -> dict:
        """Activation ranges over ``batches`` (uint8 RGB ``[B, S, S, 3]``,
        prepared as :meth:`predict` prepares them), then int8 serving.
        Returns the ranges (``ops.quant.calibrate``)."""
        ranges = calibrate(self.model, (self.to_input(b) for b in batches), self.scope)
        self.model.set_quant("int8", self.scope)
        self.needs_calibration = False
        return ranges

    def post_kwargs(self):
        c = self.cfg
        return dict(score_thr=c.score_thr, iou_thr=c.nms_iou_thr,
                    max_before_nms_per_level=c.max_before_nms_per_level,
                    max_per_img=c.max_per_img, pre_nms_cap=c.pre_nms_cap)

    def to_input(self, imgs) -> torch.Tensor:
        """``[B, H, W, 3]`` uint8 RGB (numpy or tensor) -> ``[B, 3, H, W]``
        in the compute type, scaled by float32(1/255) as the JAX loader
        scales, channels-last on the device."""
        return scale_images(torch.as_tensor(imgs).to(self.device), self.dtype)

    @torch.no_grad()
    def forward(self, x: torch.Tensor):
        """Raw head outputs of a prepared batch (see :meth:`to_input`)."""
        if self.needs_calibration:
            raise RuntimeError("quant int8: calibrate() the predictor before serving")
        return self.model(x)

    @torch.no_grad()
    def predict(self, imgs, **overrides):
        """``(det_boxes [B,K,6], det_labels [B,K], det_valid [B,K])``;
        ``overrides`` replace decode/NMS settings (e.g. ``score_thr``)."""
        out = self.forward(self.to_input(imgs))
        return s2anet_get_bboxes(out, **{**self.post_kwargs(), **overrides})


def _inputs(opt):
    """``(name, [H, W, 3] uint8 RGB)`` per input."""
    if opt.synthetic:
        rng = np.random.default_rng(opt.seed)
        for i in range(opt.synthetic):
            yield f"synthetic_{i:04d}", rng.integers(
                0, 256, (opt.img_size, opt.img_size, 3), dtype=np.uint8)
        return
    paths = sorted(Path(opt.source).glob("*.npy"))
    if not paths:
        raise SystemExit(f"no .npy images under {opt.source}")
    for p in paths:
        img = np.load(p)
        if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
            raise SystemExit(f"{p}: want [H, W, 3] uint8, got "
                             f"{list(img.shape)} {img.dtype}")
        yield p.stem, img


def serve_chips(predictor, inputs, img_size: int, gap: int, batch_size: int,
                iou_thr: float, timing=None):
    """Tile, detect and merge: yields ``(name, windows, dets)`` per input,
    in input order, ``dets`` a list of ``(class_id, score, poly[8])`` in
    the input's frame. The windows run in fixed batches (the last padded
    with zeros) through the evaluation runner's one-batch-deep pipeline
    (:class:`.eval.runner.BatchPipeline`). ``timing`` (a dict), when
    given, gathers the seconds of the model (windows staged, batches run
    and fetched) and of the merge (polygons and cross-chip NMS)."""
    timing = {} if timing is None else timing
    timing.setdefault("model", 0.0)
    timing.setdefault("merge", 0.0)
    # [name, windows, chip detections, every window staged] in input order
    open_inputs = deque()

    def windows():
        for name, img in inputs:
            entry = [name, 0, {}, False]
            open_inputs.append(entry)
            for chip_name, chip in split_image(img, name, img_size, gap):
                entry[1] += 1
                yield entry, chip_name, chip
            entry[3] = True

    pipeline = BatchPipeline(predictor, batch_size, img_size)

    def batches():
        stream = windows()
        for i in itertools.count():
            group = [w for _, w in zip(range(batch_size), stream)]
            if not group:
                return
            imgs = pipeline.slot(i)
            for k, (_, _, chip) in enumerate(group):
                imgs[k] = chip
            imgs[len(group):] = 0  # pad to the fixed batch
            yield len(group), group

    waits = {"loader_wait": 0.0, "device_wait": 0.0}
    t0 = time.perf_counter()
    with pipeline:
        for (det_boxes, det_labels, det_valid), _, group in pipeline.run(batches(), waits):
            t1 = time.perf_counter()
            timing["model"] += t1 - t0
            for k, (entry, chip_name, _) in enumerate(group):
                polys, scores = detections_to_polys(det_boxes[k], det_valid[k])
                labels = det_labels[k][det_valid[k]]
                entry[2][chip_name] = [(int(c), float(sc), p)
                                       for c, sc, p in zip(labels, scores, polys)]
            # an input is complete once all its windows are staged and back
            while open_inputs and open_inputs[0][3] and (
                    len(open_inputs[0][2]) == open_inputs[0][1]):
                name, n_windows, chip_dets, _ = open_inputs.popleft()
                dets = merge_chip_detections(chip_dets, iou_thr).get(name, [])
                timing["merge"] += time.perf_counter() - t1
                yield name, n_windows, dets
                t1 = time.perf_counter()
            timing["merge"] += time.perf_counter() - t1
            t0 = time.perf_counter()


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--source", help="directory of [H,W,3] uint8 RGB .npy images")
    src.add_argument("--synthetic", type=int, default=0,
                     help="make N random chips from --seed")
    p.add_argument("--mode", choices=["chips"], default="chips",
                   help="chips: tile, detect per window, merge")
    p.add_argument("--weights", default="",
                   help=".npz of JAX variables or .pt port state_dict; "
                        "none = random weights from --seed")
    p.add_argument("--config", default="", help="yaml config path")
    p.add_argument("--seed", type=int, default=0)
    # config-mirroring flags default to None: the config's value (else the
    # dataclass default) applies unless the flag is typed
    p.add_argument("--backbone", default=None, help="default resnet50")
    p.add_argument("--num-classes", type=int, default=None, help="default 15")
    p.add_argument("--names", default="",
                   help="class preset: dota | dota-v1.5 | dota-v2.0 | hrsc")
    p.add_argument("--no-ema", action="store_true",
                   help="a training checkpoint's model weights, not its EMA")
    p.add_argument("--batch-size", type=int, default=8, help="windows per batch")
    p.add_argument("--img-size", type=int, default=None, help="window size (default 1024)")
    p.add_argument("--gap", type=int, default=200, help="window overlap")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    p.add_argument("--device", default="cuda")
    p.add_argument("--conf", type=float, default=None,
                   help="score threshold (default: model.predict_score_thr, 0.3)")
    p.add_argument("--iou-thres", type=float, default=None,
                   help="NMS threshold, also of the cross-chip merge")
    p.add_argument("--save-dir", default="runs/predict_torch")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    opt = parse_opt(argv)
    full = load_config(opt.config or None, prune_overrides({
        "model": {"backbone": opt.backbone, "num_classes": opt.num_classes,
                  "nms_iou_thr": opt.iou_thres},
        "data": {"img_size": opt.img_size, "names": opt.names or None}}))
    cfg = full.model
    cfg = dataclasses.replace(
        cfg, score_thr=opt.conf if opt.conf is not None else cfg.predict_score_thr)
    opt.img_size = full.data.img_size
    # the window slide img_size - gap stays positive
    gap = min(opt.gap, opt.img_size // 2)
    names = full.data.names
    predictor = S2ANetPredictor(cfg, opt.weights, opt.device, DTYPES[opt.dtype],
                                opt.seed, use_ema=not opt.no_ema)
    torch.backends.cudnn.benchmark = True  # fixed shapes: autotune the convs
    save_dir = Path(opt.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)

    n_images = n_chips = n_dets = 0
    timing: dict = {}
    t0 = time.perf_counter()
    for name, n_windows, dets in serve_chips(
            predictor, _inputs(opt), opt.img_size, gap, opt.batch_size,
            cfg.nms_iou_thr, timing):
        lines = [f"{names[c]} {s:.4f} " + " ".join(f"{v:.2f}" for v in poly)
                 for c, s, poly in dets]
        (save_dir / f"{name}.txt").write_text("".join(l + "\n" for l in lines))
        print(f"{name}: {len(lines)} detections")
        n_images += 1
        n_chips += n_windows
        n_dets += len(lines)
    summary = {"images": n_images, "chips": n_chips, "detections": n_dets,
               "seconds": round(time.perf_counter() - t0, 3),
               "model_seconds": round(timing["model"], 3),
               "merge_seconds": round(timing["merge"], 3),
               "native_polyiou": native.AVAILABLE,
               "device": str(predictor.device), "save_dir": str(save_dir)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
