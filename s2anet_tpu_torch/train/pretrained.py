"""ImageNet-initialised backbone: a torchvision ResNet ``state_dict`` into
the port's backbone.

Counterpart of ``s2anet_tpu/models/torch_import.py::load_pretrained_backbone``
(``--pretrained PATH|auto``). The port's backbone keeps the reference's
torch layout, so the map is a renaming: ``conv1``/``bn1`` ->
``backbone.backbone.0.{0,1}``, ``layer1`` -> ``backbone.backbone.1.1``,
``layer2..4`` -> ``backbone.backbone.2..4``; block keys (``conv{i}``,
``bn{i}``, ``downsample.{0,1}``) are the same. The conv weights and the BN
weight, bias and running statistics are loaded (``fc`` and the BN batch
counts are not, as in the JAX function); a missing key raises.
"""

from __future__ import annotations

import re
from pathlib import Path

import torch
from torch import nn

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def torchvision_to_port(name: str):
    """A torchvision ResNet key -> the port's key (None for keys the port
    does not load)."""
    m = re.match(r"(conv1|bn1)\.(\w+)$", name)
    if m:
        if m.group(1) == "bn1" and m.group(2) not in _BN_KEYS:
            return None
        return f"backbone.backbone.0.{0 if m.group(1) == 'conv1' else 1}.{m.group(2)}"
    m = re.match(r"layer([1-4])\.(.+)$", name)
    if m is None or name.endswith("num_batches_tracked"):
        return None
    stage = int(m.group(1))
    prefix = "backbone.backbone.1.1" if stage == 1 else f"backbone.backbone.{stage}"
    return f"{prefix}.{m.group(2)}"


def resolve(spec: str, arch: str) -> Path:
    """``spec`` is a path, or ``auto``: the newest ``<arch>*.pth`` in the
    torch hub cache of this user."""
    if spec != "auto":
        return Path(spec)
    cache = Path.home() / ".cache" / "torch" / "hub" / "checkpoints"
    cands = sorted(cache.glob(f"{arch}*.pth")) if cache.is_dir() else []
    if not cands:
        raise FileNotFoundError(f"--pretrained auto: no {arch}*.pth in {cache}; pass an "
                                f"explicit path to a torchvision state dict")
    return cands[-1]


@torch.no_grad()
def load_pretrained_backbone(model: nn.Module, spec: str, arch: str = "resnet50") -> int:
    """Load the torchvision ``state_dict`` named by ``spec`` into
    ``model.backbone``; returns the number of tensors loaded."""
    sd = torch.load(resolve(spec, arch), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    mapped = {}
    for k, v in sd.items():
        dst = torchvision_to_port(k)
        if dst is not None:
            mapped[dst] = v
    own = model.state_dict()
    want = {k for k in own if k.startswith("backbone.backbone.")
            and not k.endswith("num_batches_tracked")}
    missing, extra = want - set(mapped), set(mapped) - want
    if missing or extra:
        raise KeyError(f"pretrained {arch} state dict does not fit the backbone: "
                       f"missing {sorted(missing)[:4]}, unexpected {sorted(extra)[:4]}")
    for k, v in mapped.items():
        own[k].copy_(v)
    return len(mapped)
