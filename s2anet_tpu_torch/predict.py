"""Serve S2ANet on images of any size: ``python -m s2anet_tpu_torch.predict``.

The PyTorch/CUDA counterpart of the repository's ``predict.py``, in its two
modes:

* ``--mode chips`` (the default): every input is tiled into ``--img-size``
  windows overlapping by ``--gap`` (:func:`.data.split.split_image`; an
  input no larger than one window is one zero-padded window), the windows
  run in fixed batches of ``--batch-size`` through the detector, decode and
  multiclass rotated NMS, and each input's detections are shifted back and
  merged by cross-chip polygon NMS at ``--iou-thres``
  (:func:`.data.merge.merge_chip_detections`).
* ``--mode spatial``: each input runs whole, zero-padded to H a multiple of
  128 x ranks and W a multiple of 128, with no tiling and no merge. One
  process runs the whole image on one GPU; under ``torchrun
  --nproc_per_node N`` the image's height is sharded over the N ranks
  (:mod:`.parallel.spatial`: conv halos, the AlignConv halo, the outputs
  gathered for one decode and NMS on rank 0). ``--gap``, ``--img-size``
  and ``--batch-size`` belong to chips mode and are refused here, and so
  is a quantised config: spatial mode is float, as in the repository's.

Both modes scale the uint8 input as the repository's ``predict.py`` does,
divided by 255 in float32 on the device, then cast to the compute type
(``val`` and training multiply by float32(1/255), as the JAX loader does).
Per input (rank 0 in spatial mode) it writes ``<save-dir>/<name>.txt``
with one ``class score x1 y1 x2 y2 x3 y3 x4 y4`` line per detection (a
lone newline where there is none), with ``--save-img`` the input with its
detections drawn (:func:`.utils.plots.draw_rboxes`) as ``<name>.png``,
prints one ``<name>: N detections`` line, and at the end writes the DOTA
submission ``<save-dir>/dota_submission/Task1_<class>.txt`` over all
inputs and a JSON summary line (``mode``, ``ranks``, the model seconds
apart from the merge's in chips mode or the decode's in spatial mode, and
this process's launches of each serving kernel). Class names are
``predict.py``'s: the ``--names`` preset (else the DOTA-v1.0 list), and
``0``, ``1``, ... where its length is not the number of classes.

Inputs: ``--source`` is an image file or a directory of image files
(``predict.py``'s extensions), each read as ``cv2.imread`` reads it: its
BGR ``.npy`` sidecar where one is newer than the image (the JAX loader's
``cache_images: disk``), else the file (:func:`.data.image.imread`: PNG
and BMP here, other formats through PIL where it is installed), then
turned to RGB; a file that is not an image is skipped, as in
``predict.py``. With ``--npy``, ``--source`` is a ``.npy`` file or a
directory of them, each ``[H, W, 3]`` uint8 **RGB**, any size (a ``.npy``
with an image of its stem beside it is a BGR sidecar and is refused);
``--synthetic N`` makes N random images of ``--img-size`` (in spatial mode
the config's window size) from ``--seed``. The ``.png`` drawings are a
named divergence from ``predict.py``'s ``.jpg`` (the card's machine has no
JPEG encoder), and so are the label glyphs (a bitmap font, not Hershey's).
Weights: ``--weights`` takes an ``.npz`` of JAX-layout variables
(:func:`.models.convert.save_jax_npz`), a port ``state_dict`` (the
trainer's ``weights/deploy``) or a training checkpoint (``weights/last``,
``best``, ``epochN``: its EMA weights, or its model's with ``--no-ema``);
with none, the weights are random from ``--seed``. ``--config`` reads a
YAML config: ``--backbone``, ``--num-classes``, ``--img-size``,
``--iou-thres`` and ``--names`` replace its values when typed, and
``--conf`` defaults to its ``model.predict_score_thr`` (0.3).

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
import torch.distributed as dist

from . import native
from .config import NAMES_PRESETS, ModelConfig, load_config, prune_overrides
from .data.dota import sidecar_fresh
from .data.image import imread
from .data.merge import merge_chip_detections
from .data.split import DOTA_CLASSES, split_image
from .data.synth import write_png
from .eval.runner import BatchPipeline, detections_to_polys, save_dota_results
from .models.convert import load_jax_npz, state_dict_from_jax
from .models.detector import S2ANet
from .models.fold import fold_bn
from .models.head import s2anet_get_bboxes
from .ops.deform_conv import DEFORM_FWD
from .ops.nms_rotated import NMS_MASK, NMS_SWEEP
from .ops.quant import CONV, QUANTIZE, calibrate, parse_scope
from .ops.rbox import poly_to_rbox_np
from .parallel import mesh
from .parallel.spatial import padded_size, spatial_forward
from .train.step import scale_images
from .utils.plots import draw_rboxes
from .utils.profiler import span

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp"}  # predict.py's
KERNELS = (DEFORM_FWD, NMS_MASK, NMS_SWEEP, QUANTIZE, CONV)  # the serving path's
# cuDNN autotuning by mode. Chips mode runs one batch shape. Spatial mode
# meets a new shape with nearly every scene size, where autotuning costs
# seconds on an H100 and buys no faster repeat scene (chip_smoke phase 17a
# times both)
CUDNN_BENCHMARK = {"chips": True, "spatial": False}


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
    raises.

    ``divide``: scale the uint8 input by a division by 255 in float32 (the
    repository's ``predict.py``); else by the product with float32(1/255)
    (the JAX loader's, for ``val``). The two differ by one ulp on 126 of
    the 256 levels."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), weights: str = "",
                 device: str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0, use_ema: bool = True, divide: bool = False):
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"quant {cfg.quant!r}: expected none | int8")
        self.scope = parse_scope(cfg.quant_scope)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device")
        self.cfg = cfg
        self.dtype = dtype
        self.divide = divide
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
        in the compute type, scaled on the device (see ``divide``),
        channels-last."""
        return scale_images(torch.as_tensor(imgs).to(self.device), self.dtype, self.divide)

    @torch.no_grad()
    def forward(self, x: torch.Tensor):
        """Raw head outputs of a prepared batch (see :meth:`to_input`)."""
        if self.needs_calibration:
            raise RuntimeError("quant int8: calibrate() the predictor before serving")
        return self.model(x)

    @torch.no_grad()
    def predict(self, imgs, **overrides):
        """``(det_boxes [B,K,6], det_labels [B,K], det_valid [B,K])``;
        ``overrides`` replace decode/NMS settings (e.g. ``score_thr``).
        Under a profiler the call is the span ``s2anet.predict``."""
        with span("s2anet.predict"):
            out = self.forward(self.to_input(imgs))
            return s2anet_get_bboxes(out, **{**self.post_kwargs(), **overrides})


def _list_images(source: str, exts):
    """``predict.py``'s ``_list_images``: a file as it is, else the
    directory's files with one of ``exts``, sorted."""
    src = Path(source)
    if src.is_file():
        return [src]
    paths = sorted(p for p in src.iterdir() if p.suffix.lower() in exts)
    if not paths:
        raise SystemExit(f"no images found under {src}")
    return paths


def read_bgr(path: Path):
    """``cv2.imread(path)``: the fresh BGR sidecar, else the file
    (:func:`.data.image.imread`); None for a file that is not an image."""
    if sidecar_fresh(path):
        return np.load(path.with_suffix(".npy"))
    return imread(path)


def _inputs(opt):
    """``(name, [H, W, 3] uint8 RGB)`` per input."""
    if opt.synthetic:
        rng = np.random.default_rng(opt.seed)
        for i in range(opt.synthetic):
            yield f"synthetic_{i:04d}", rng.integers(
                0, 256, (opt.img_size, opt.img_size, 3), dtype=np.uint8)
        return
    if opt.npy:
        for p in _list_images(opt.source, {".npy"}):
            beside = [p.with_suffix(e) for e in sorted(IMG_EXTS) if p.with_suffix(e).exists()]
            if beside:
                raise SystemExit(f"{p}: a BGR sidecar of {beside[0].name}; --npy takes "
                                 f"RGB arrays (serve the image without --npy)")
            img = np.load(p)
            if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
                raise SystemExit(f"{p}: want [H, W, 3] uint8, got "
                                 f"{list(img.shape)} {img.dtype}")
            yield p.stem, img
        return
    for p in _list_images(opt.source, IMG_EXTS):
        if p.suffix.lower() == ".npy":
            raise SystemExit(f"{p}: a .npy array; serve RGB arrays with --npy")
        img = read_bgr(p)
        if img is None:
            print(f"skipping unreadable image {p}")
            continue
        yield p.stem, np.ascontiguousarray(img[:, :, ::-1])


def class_names(names_opt: str, num_classes: int):
    """``predict.py``'s output names: the ``--names`` preset, else the
    DOTA-v1.0 list; ``0``, ``1``, ... where its length is not
    ``num_classes``."""
    names = NAMES_PRESETS.get(names_opt.lower(), DOTA_CLASSES)
    if len(names) != num_classes:
        names = [str(i) for i in range(num_classes)]
    return list(names)


def draw(rgb: np.ndarray, dets, names) -> np.ndarray:
    """``predict.py``'s drawing of ``dets`` on the BGR image of ``rgb``:
    the minimum-area rotated box of each polygon, labelled; BGR out."""
    bgr = np.ascontiguousarray(rgb[:, :, ::-1])
    if not dets:
        return bgr
    rb = poly_to_rbox_np(np.stack([np.asarray(p).reshape(8) for _, _, p in dets]))
    return draw_rboxes(bgr, rb, classes=[c for c, _, _ in dets],
                       scores=[s for _, s, _ in dets], names=names)


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
            for chip_name, chip, _ in split_image(img, [], name, img_size, gap):
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


@torch.no_grad()
def serve_spatial(predictor, inputs, timing=None):
    """Each input whole, its height sharded over the group's ranks (one
    rank: the whole image): yields ``(name, dets)`` per input, in input
    order, ``dets`` a list of ``(class_id, score, poly[8])`` in the input's
    frame on rank 0 and None on the other ranks. Every rank reads every
    input and stages its own rows of the padded image (zeros past the
    input); rank 0 decodes. ``timing`` (a dict), when given, gathers the
    seconds of the model (rows staged, the forward, the outputs gathered,
    to the device's end) and of the decode (top-k, NMS, polygons), under a
    profiler the spans ``s2anet.spatial.model`` and
    ``s2anet.spatial.decode``."""
    timing = {} if timing is None else timing
    timing.setdefault("model", 0.0)
    timing.setdefault("decode", 0.0)
    world, rank = mesh.world_size(), mesh.rank()
    cuda = predictor.device.type == "cuda"
    for name, img in inputs:
        h0, w0 = img.shape[:2]
        hp, wp = padded_size(h0, w0, world)
        part = hp // world
        lo, hi = rank * part, min((rank + 1) * part, h0)
        rows_u8 = np.zeros((1, part, wp, 3), np.uint8)
        rows_u8[0, :max(hi - lo, 0), :w0] = img[lo:hi]
        with span("s2anet.spatial.model", timing, "model"):
            out = spatial_forward(predictor.forward, predictor.to_input(rows_u8))
            if cuda:
                torch.cuda.synchronize(predictor.device)
        if rank != 0:
            yield name, None
            continue
        with span("s2anet.spatial.decode", timing, "decode"):
            det_boxes, det_labels, det_valid = (
                t[0].cpu().numpy() for t in s2anet_get_bboxes(out, **predictor.post_kwargs()))
            polys, scores = detections_to_polys(det_boxes, det_valid)
            dets = [(int(c), float(sc), p)
                    for c, sc, p in zip(det_labels[det_valid], scores, polys)]
        yield name, dets


CHIPS_ONLY = {"gap": 200, "img_size": None, "batch_size": 8}  # chips-mode flags, defaults


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--source", help="image file or directory (with --npy: .npy "
                                      "file or directory of [H,W,3] uint8 RGB)")
    src.add_argument("--synthetic", type=int, default=0,
                     help="make N random chips from --seed")
    p.add_argument("--npy", action="store_true",
                   help="--source holds [H,W,3] uint8 RGB .npy arrays, not image files")
    p.add_argument("--save-img", action="store_true",
                   help="write each input with its detections drawn, <name>.png")
    p.add_argument("--mode", choices=["chips", "spatial"], default="chips",
                   help="chips: tile, detect per window, merge; spatial: each image "
                        "whole, its height sharded over torchrun's ranks")
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
    p.add_argument("--batch-size", type=int, default=None,
                   help="windows per batch (chips mode, default 8)")
    p.add_argument("--img-size", type=int, default=None,
                   help="window size (chips mode, default 1024)")
    p.add_argument("--gap", type=int, default=None,
                   help="window overlap (chips mode, default 200)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    p.add_argument("--device", default="cuda")
    p.add_argument("--conf", type=float, default=None,
                   help="score threshold (default: model.predict_score_thr, 0.3)")
    p.add_argument("--iou-thres", type=float, default=None,
                   help="NMS threshold, also of the cross-chip merge")
    p.add_argument("--save-dir", default="runs/predict_torch")
    opt = p.parse_args(argv)
    typed = [k for k in CHIPS_ONLY if getattr(opt, k) is not None]
    if opt.mode == "spatial" and typed:
        p.error(", ".join("--" + k.replace("_", "-") for k in typed)
                + ": chips mode only (spatial mode runs each image whole)")
    for k, default in CHIPS_ONLY.items():
        if getattr(opt, k) is None and default is not None:
            setattr(opt, k, default)
    return opt


def main(argv=None) -> dict:
    opt = parse_opt(argv)
    full = load_config(opt.config or None, prune_overrides({
        "model": {"backbone": opt.backbone, "num_classes": opt.num_classes,
                  "nms_iou_thr": opt.iou_thres},
        "data": {"img_size": opt.img_size, "names": opt.names or None}}))
    cfg = full.model
    cfg = dataclasses.replace(
        cfg, score_thr=opt.conf if opt.conf is not None else cfg.predict_score_thr)
    spatial = opt.mode == "spatial"
    if spatial and cfg.quant != "none":
        raise ValueError(f"--mode spatial is float only: the config sets quant {cfg.quant!r}")
    opt.img_size = full.data.img_size
    names = class_names(opt.names, cfg.num_classes)
    ours = spatial and not dist.is_initialized()  # a group this call joins, it leaves
    device = mesh.maybe_initialize_distributed(device=opt.device) if spatial else opt.device
    main_rank = mesh.is_main_process()
    predictor = S2ANetPredictor(cfg, opt.weights, device, DTYPES[opt.dtype],
                                opt.seed, use_ema=not opt.no_ema)
    predictor.divide = True  # the repository's predict.py scaling
    torch.backends.cudnn.benchmark = CUDNN_BENCHMARK[opt.mode]
    save_dir = Path(opt.save_dir)
    if main_rank:
        save_dir.mkdir(parents=True, exist_ok=True)

    n_images = n_chips = n_dets = 0
    timing: dict = {}
    counts = {k.symbol: k.launches for k in KERNELS}
    kept = {}  # the inputs still to draw (--save-img)

    def inputs():
        for name, img in _inputs(opt):
            if opt.save_img and main_rank:
                kept[name] = img
            yield name, img

    t0 = time.perf_counter()
    if spatial:
        served = ((name, 1, dets) for name, dets in serve_spatial(predictor, inputs(), timing))
    else:
        # the window slide img_size - gap stays positive
        served = serve_chips(predictor, inputs(), opt.img_size,
                             min(opt.gap, opt.img_size // 2), opt.batch_size,
                             cfg.nms_iou_thr, timing)
    by_class: dict = {}
    for name, n_windows, dets in served:
        n_images += 1
        n_chips += n_windows
        if not main_rank:
            continue
        lines = []
        for c, s, poly in dets:
            by_class.setdefault(c, []).append((name, s, poly))
            lines.append(f"{names[c]} {s:.4f} " + " ".join(f"{v:.2f}" for v in poly))
        (save_dir / f"{name}.txt").write_text("\n".join(lines) + "\n")
        if opt.save_img:
            write_png(save_dir / f"{name}.png", draw(kept.pop(name), dets, names)[:, :, ::-1])
        print(f"{name}: {len(lines)} detections")
        n_dets += len(lines)
    if main_rank:
        save_dota_results(by_class, names, save_dir / "dota_submission")
    summary = {"mode": opt.mode, "ranks": mesh.world_size(), "images": n_images}
    if not spatial:
        summary["chips"] = n_chips
    summary.update({"detections": n_dets,
                    "seconds": round(time.perf_counter() - t0, 3),
                    "model_seconds": round(timing["model"], 3)})
    second = "decode" if spatial else "merge"
    summary[f"{second}_seconds"] = round(timing[second], 3)
    summary["launches"] = {k.symbol: k.launches - counts[k.symbol] for k in KERNELS}
    summary.update({"native_polyiou": native.AVAILABLE,
                    "device": str(predictor.device), "save_dir": str(save_dir)})
    if main_rank:
        print(json.dumps(summary))
    if ours:
        mesh.shutdown()
    return summary


if __name__ == "__main__":
    main()
