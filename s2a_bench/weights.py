"""Seeded weights, made on the device in one draw, handed to both sides.

The parameter list is the reference's (``reference/model.py``, built on
the meta device: nothing is allocated), in the published checkpoints' key
layout, which the program loads as it is. One ``torch.randn`` on a CUDA
generator (a CPU generator where there is no card) draws every value;
each tensor is a slice of it scaled for its kind, as the configuration's
``init`` block says:

* backbone convs: He-normal over the fan-out; FPN convs: normal with
  Xavier's variance; head convs: ``head_std`` (the ODM classification
  head ``cls_head_std``, the two regression heads ``reg_head_std``), biases zero, the two classification heads'
  biases at the prior ``cls_prior``;
* BatchNorm: ``gamma = 1 + bn_std * n``, ``beta = bn_std * n``, running
  mean ``bn_std * n``, running variance ``exp(bn_std * n)``, so that
  folding and the batch statistics both have work to do.
"""

from __future__ import annotations

import math

import torch

from .reference.model import from_config


def parameter_spec(model_cfg: dict):
    """``[(key, shape)]`` of every floating tensor of the state dict, and
    the integer buffers' keys."""
    with torch.device("meta"):
        ref = from_config(model_cfg)
    floats, ints = [], []
    for k, v in ref.state_dict().items():
        (floats if v.is_floating_point() else ints).append((k, tuple(v.shape)))
    return floats, ints


def _std(key: str, shape, init: dict) -> float:
    if key.startswith("backbone.") and len(shape) == 4:
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if key.startswith("neck.") and len(shape) == 4:
        rf = shape[2] * shape[3]
        return math.sqrt(2.0 / (shape[1] * rf + shape[0] * rf))
    if key == "head.odm_cls_head.weight":
        return init["cls_head_std"]
    if key in ("head.fam_reg_head.weight", "head.odm_reg_head.weight"):
        return init["reg_head_std"]
    if key.startswith("head.") and len(shape) >= 4:
        return init["head_std"]
    return 0.0


def make_state_dict(model_cfg: dict, init: dict, seed: int, device) -> dict:
    """The seeded float32 ``state_dict`` on ``device``."""
    floats, ints = parameter_spec(model_cfg)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    total = sum(math.prod(s) for _, s in floats)
    draw = torch.randn(total, generator=gen, device=device)
    prior = -math.log((1 - init["cls_prior"]) / init["cls_prior"])
    bn = init["bn_std"]
    sd, at = {}, 0
    for key, shape in floats:
        n = math.prod(shape)
        z = draw[at:at + n].view(shape)
        at += n
        leaf = key.rsplit(".", 1)[-1]
        if ".bn" in key or key.startswith("backbone.backbone.0.1.") or ".downsample.1." in key:
            t = {"weight": 1 + bn * z, "bias": bn * z, "running_mean": bn * z,
                 "running_var": torch.exp(bn * z)}[leaf]
        elif leaf == "bias":
            fill = prior if key in ("head.fam_cls_head.bias", "head.odm_cls_head.bias") else 0.0
            t = torch.full(shape, fill, device=device)
        else:
            t = _std(key, shape, init) * z
        sd[key] = t
    for key, shape in ints:
        sd[key] = torch.zeros(shape, dtype=torch.int64, device=device)
    return sd
