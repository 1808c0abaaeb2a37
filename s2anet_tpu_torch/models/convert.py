"""JAX variables -> the port's ``state_dict``.

The inverse of ``s2anet_tpu/models/torch_import.py::convert_reference_s2anet``:
it maps the JAX ``{"params", "batch_stats"}`` tree (nested dicts of arrays,
BatchNorms unfolded) to the reference torch key layout that the port's
modules use, transposing conv kernels HWIO -> OIHW; a ``PAN`` neck's tree (its FPN
under ``fpn``, then ``pan_down_i`` and ``pan_out_i``) maps to the port
``PAN``'s keys (:func:`neck_state_dict_from_jax`). ``or_weight``
``[Cout/8, Cin, 1, 3, 3]`` is already in torch layout and is copied as it is;
a head built with ``with_orconv=False`` has a plain ``or_conv`` conv
(kernel and bias) instead, which becomes ``or_conv.weight``/``bias`` the
same way. (The JAX package's bridge, ``convert_reference_s2anet``, reads a
4-D ``or_conv.weight`` back into ``or_conv/kernel`` but files its bias
under ``or_bias``.)

The calibrated int8 activation ranges (the JAX ``"quant"`` collection:
``act_min``/``act_max`` per quantised conv, ``or_act_min``/``or_act_max``
on the head for the ORConv) map to and from the port's range buffers by
module name (:func:`quant_ranges_from_jax`, :func:`quant_ranges_to_jax`).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .resnet import ARCH_SETTINGS


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _oihw(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def state_dict_from_jax(variables, arch: str = "resnet50") -> Dict[str, torch.Tensor]:
    """JAX S2ANet variables (unfolded BatchNorms) -> port ``state_dict``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def conv(dst, src, bias=True):
        sd[dst + ".weight"] = _oihw(src["kernel"])
        if bias:
            sd[dst + ".bias"] = _t(src["bias"])

    def bn(dst, p, s):
        sd[dst + ".weight"] = _t(p["scale"])
        sd[dst + ".bias"] = _t(p["bias"])
        sd[dst + ".running_mean"] = _t(s["mean"])
        sd[dst + ".running_var"] = _t(s["var"])
        sd[dst + ".num_batches_tracked"] = torch.tensor(0)

    bp, bs = params["backbone"], stats["backbone"]
    conv("backbone.backbone.0.0", bp["conv1"], bias=False)
    bn("backbone.backbone.0.1", bp["bn1"], bs["bn1"])
    kind, layer_cfg = ARCH_SETTINGS[arch]
    n_convs = 2 if kind == "basic" else 3
    for stage, n_blocks in enumerate(layer_cfg, start=1):
        prefix = "backbone.backbone.1.1" if stage == 1 else f"backbone.backbone.{stage}"
        for b in range(n_blocks):
            src = f"layer{stage}_{b}"
            dst = f"{prefix}.{b}"
            for c in range(1, n_convs + 1):
                conv(f"{dst}.conv{c}", bp[src][f"conv{c}"], bias=False)
                bn(f"{dst}.bn{c}", bp[src][f"bn{c}"], bs[src][f"bn{c}"])
            if "downsample_conv" in bp[src]:
                conv(f"{dst}.downsample.0", bp[src]["downsample_conv"], bias=False)
                bn(f"{dst}.downsample.1", bp[src]["downsample_bn"],
                   bs[src]["downsample_bn"])

    sd.update(neck_state_dict_from_jax(params["neck"], prefix="neck."))
    sd.update(head_state_dict_from_jax(params["head"], prefix="head."))
    return sd


def neck_state_dict_from_jax(np_, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``FPN`` params (``lateral_i``, ``fpn_i``) or ``PAN`` params (an
    ``fpn`` subtree, ``pan_down_i``, ``pan_out_i``) -> the port neck's
    ``state_dict`` keys."""
    sd: Dict[str, torch.Tensor] = {}
    if "fpn" in np_:  # a PAN
        sd.update(neck_state_dict_from_jax(np_["fpn"], prefix + "fpn."))
        names = (("pan_down", "pan_down_convs"), ("pan_out", "pan_out_convs"))
    else:
        names = (("lateral", "lateral_convs"), ("fpn", "fpn_convs"))
    for src, dst in names:
        i = 0
        while f"{src}_{i}" in np_:
            sd[f"{prefix}{dst}.{i}.weight"] = _oihw(np_[f"{src}_{i}"]["kernel"])
            sd[f"{prefix}{dst}.{i}.bias"] = _t(np_[f"{src}_{i}"]["bias"])
            i += 1
    return sd


def head_state_dict_from_jax(hp, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``S2ANetHead`` params -> the port head's ``state_dict`` keys."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(dst, src):
        sd[prefix + dst + ".weight"] = _oihw(src["kernel"])
        sd[prefix + dst + ".bias"] = _t(src["bias"])

    for name in ("fam_reg_ls", "fam_cls_ls", "odm_reg_ls", "odm_cls_ls"):
        j = 0
        while f"conv{j}" in hp[name]:
            conv(f"{name}.{j}.0", hp[name][f"conv{j}"])
            j += 1
    for name in ("fam_reg_head", "fam_cls_head", "odm_reg_head", "odm_cls_head"):
        conv(name, hp[name])
    sd[prefix + "align_conv.deform_conv.weight"] = _oihw(hp["align_weight"])
    if "or_conv" in hp:  # with_orconv=False
        conv("or_conv", hp["or_conv"])
    else:
        sd[prefix + "or_conv.weight"] = _t(hp["or_weight"])
        sd[prefix + "or_conv.bias"] = _t(hp["or_bias"])
    return sd


def save_jax_npz(path, variables) -> None:
    """Write a nested-dict variables tree as one ``.npz`` with ``/``-joined
    keys (``params/backbone/conv1/kernel``)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node, dtype=np.float32)

    walk("", variables)
    np.savez(path, **flat)


def load_jax_npz(path):
    """Read a variables tree written by :func:`save_jax_npz`."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def _jax_quant_path(name: str):
    """JAX ``"quant"`` path of the port module ``name`` and its two leaf
    names."""
    m = re.fullmatch(r"backbone\.backbone\.(?:1\.1|(\d))\.(\d+)\.(conv\d|downsample\.0)", name)
    if m:
        stage = m.group(1) or "1"
        conv = "downsample_conv" if m.group(3) == "downsample.0" else m.group(3)
        return ("backbone", f"layer{stage}_{m.group(2)}", conv), "act_min", "act_max"
    # an FPN's convs, or a PAN's (its inner FPN under ``fpn``), in a
    # detector's ``neck`` or alone
    m = re.fullmatch(r"(neck\.)?(fpn\.)?(lateral|fpn)_convs\.(\d+)", name)
    if m:
        outer = ("neck",) * bool(m.group(1)) + ("fpn",) * bool(m.group(2))
        return outer + (f"{m.group(3)}_{m.group(4)}",), "act_min", "act_max"
    m = re.fullmatch(r"(neck\.)?pan_(down|out)_convs\.(\d+)", name)
    if m:
        return (("neck",) * bool(m.group(1))
                + (f"pan_{m.group(2)}_{m.group(3)}",)), "act_min", "act_max"
    m = re.fullmatch(r"head\.(\w+_ls)\.(\d+)\.0", name)
    if m:
        return ("head", m.group(1), f"conv{m.group(2)}"), "act_min", "act_max"
    if name == "head.or_conv":
        return ("head",), "or_act_min", "or_act_max"
    m = re.fullmatch(r"head\.(\w+_head)", name)
    if m:
        return ("head", m.group(1)), "act_min", "act_max"
    raise KeyError(f"no JAX quant path for module {name!r}")


def quant_ranges_from_jax(quant, names) -> Dict[str, tuple]:
    """The JAX ``"quant"`` collection -> ``{module name: (act_min,
    act_max)}`` float32 tensors for the port modules ``names`` that it
    holds ranges for."""
    out = {}
    for name in names:
        path, lo, hi = _jax_quant_path(name)
        node = quant
        for key in path:
            node = node.get(key, {}) if isinstance(node, dict) else {}
        if lo in node:
            out[name] = (_t(node[lo]), _t(node[hi]))
    return out


def quant_ranges_to_jax(ranges: Dict[str, tuple]) -> dict:
    """``{module name: (act_min, act_max)}`` -> the JAX ``"quant"``
    collection (nested dicts of float32 arrays)."""
    tree: dict = {}
    for name, (amin, amax) in ranges.items():
        path, lo, hi = _jax_quant_path(name)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[lo] = np.asarray(amin.detach().cpu(), np.float32)
        node[hi] = np.asarray(amax.detach().cpu(), np.float32)
    return tree
