"""Export the serving detector with ``torch.export``: ``python -m
s2anet_tpu_torch.export``.

The counterpart of the repository's ``tools/export.py`` (``jax.export`` to
StableHLO). The whole inference function -- backbone, FPN, head, decode and
multiclass rotated NMS, BatchNorm folded, the weights baked in -- is traced
into one ``ExportedProgram`` and written with ``torch.export.save``. Its
signature is the JAX artifact's::

    float32 NHWC imgs [B, S, S, 3] in [0, 1]
      -> (det_boxes [B, K, 6], det_labels [B, K], det_valid [B, K])

with ``K = model.max_per_img``. The serving module is built as
:class:`.predict.S2ANetPredictor` builds it (BatchNorm folded, cast to
``--dtype``, channels-last), and the ``model`` section's decode and NMS
settings are constants of the graph. The AlignConv and the two NMS kernels
are the custom ops of :mod:`.ops.library`, one node each in the graph, so
the program runs the CUDA kernels on the card and their plain versions on
the CPU: a program holds the device it was exported on (``--device``).

The program reloads without the package's model code::

    import torch
    import s2anet_tpu_torch.ops.library  # registers the s2anet ops
    program = torch.export.load("s2anet.pt2").module()
    det_boxes, det_labels, det_valid = program(imgs)

Usage (the card by default; ``--device cpu`` here)::

    python -m s2anet_tpu_torch.export --weights run/weights/deploy --out s2anet.pt2
    python -m s2anet_tpu_torch.export --weights jax_run.npz --batch-size 8 --img-size 1024

``--weights`` takes whatever :func:`.predict.load_state_dict` reads: an
``.npz`` of JAX variables (``tools/jax_to_torch_weights.py`` writes one
from a JAX checkpoint), a deploy ``state_dict`` or a training checkpoint
(its EMA weights, or its model's with ``--no-ema``); none gives random
weights from seed 0 (smoke use). Float only, as the JAX export.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch
from torch import nn

from .config import load_config, prune_overrides
from .models.head import s2anet_get_bboxes
from .predict import DTYPES, S2ANetPredictor


class ServingModule(nn.Module):
    """``imgs [B, S, S, 3]`` float32 in [0, 1] -> ``(det_boxes, det_labels,
    det_valid)``: a prepared detector (folded, cast, on its device) and its
    decode / NMS settings."""

    def __init__(self, model: nn.Module, dtype: torch.dtype, post_kwargs: dict):
        super().__init__()
        self.model = model
        self.dtype = dtype
        self.post_kwargs = dict(post_kwargs)

    def forward(self, imgs: torch.Tensor):
        x = imgs.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return s2anet_get_bboxes(self.model(x), **self.post_kwargs)


def serving_module(pred: S2ANetPredictor) -> ServingModule:
    """The predictor's model as a :class:`ServingModule` with its
    parameters frozen (no autograd in the trace)."""
    for p in pred.model.parameters():
        p.requires_grad_(False)
    return ServingModule(pred.model, pred.dtype, pred.post_kwargs()).eval()


def export_serving(module: ServingModule, batch: int, size: int, device) -> torch.export.ExportedProgram:
    """Trace ``module`` on a ``[batch, size, size, 3]`` float32 example on
    ``device``. One image goes through it first, so the head's anchor grids
    are cached on ``device`` and the trace (on fake tensors) holds them as
    constants of the program, not as operations at every call."""
    example = torch.zeros(batch, size, size, 3, device=device)
    with torch.no_grad():
        module(example[:1])
        return torch.export.export(module, (example,))


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="", help="yaml config path")
    p.add_argument("--weights", default="",
                   help=".npz of JAX variables, deploy state_dict or training "
                        "checkpoint; none = random weights (smoke use)")
    # config-mirroring flags default to None: a value from --config stays
    # unless the flag is typed
    p.add_argument("--backbone", default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                   help="compute type (default: the config's train.dtype)")
    p.add_argument("--no-ema", action="store_true",
                   help="a training checkpoint's model weights, not its EMA")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="s2anet.pt2")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    opt = parse_opt(argv)
    cfg = load_config(opt.config or None, prune_overrides({
        "model": {"backbone": opt.backbone, "num_classes": opt.num_classes},
        "data": {"img_size": opt.img_size},
        "train": {"dtype": opt.dtype}}))
    if cfg.model.quant != "none":
        raise ValueError(f"export is float only: the config sets quant {cfg.model.quant!r}")
    size, dtype = cfg.data.img_size, DTYPES[cfg.train.dtype]
    pred = S2ANetPredictor(cfg.model, opt.weights, opt.device, dtype, use_ema=not opt.no_ema)
    program = export_serving(serving_module(pred), opt.batch_size, size, pred.device)
    torch.export.save(program, opt.out)
    outs = [tuple(n.meta["val"].shape) for n in program.graph.output_node().args[0]]
    summary = {"out": opt.out, "bytes": Path(opt.out).stat().st_size,
               "input": [opt.batch_size, size, size, 3], "outputs": [list(o) for o in outs],
               "dtype": cfg.train.dtype, "device": str(pred.device)}
    print(f"exported {opt.out}: {summary['bytes'] / 1e6:.1f} MB, in {tuple(summary['input'])} "
          f"float32 -> {outs} ({cfg.train.dtype} on {pred.device})")
    return summary


if __name__ == "__main__":
    main()
