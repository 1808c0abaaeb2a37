"""Analytic FLOPs of a function from its ``torch.export`` graph: ``2 x MACs``
of the convolutions and matrix products of the nodes that reach an output
(elementwise work not counted, the convention of the model-FLOP share).

A frozen copy of the program's ``utils/flops.py`` counting, applied here to
the benchmark's own reference at a cell's shapes, so that the numerator of
``mfu.*`` is fixed by the configuration and the inputs and not by what the
program computes. Export traces with fake tensors: nothing runs.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

_aten = torch.ops.aten
CONVS = {_aten.convolution.default, _aten.conv2d.default, _aten._convolution.default}
MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
           _aten.baddbmm.default, _aten.matmul.default, _aten.linear.default}
_CHECKS = {_aten._assert_tensor_metadata.default}


def _shape(node) -> tuple:
    return tuple(node.meta["val"].shape)


def node_flops(node) -> int:
    if node.op != "call_function":
        return 0
    t = node.target
    if t in CONVS:
        w = _shape(node.args[1])
        return 2 * math.prod(_shape(node)) * math.prod(w[1:])
    if t in MATMULS:
        a = node.args[1] if t in (_aten.addmm.default, _aten.baddbmm.default) else node.args[0]
        return 2 * math.prod(_shape(node)) * _shape(a)[-1]
    return 0


class _Fn(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def count_fn_flops(fn, *args) -> int:
    """FLOPs of ``fn(*args)`` after dead-code removal."""
    module = fn if isinstance(fn, nn.Module) else _Fn(fn)
    with torch.no_grad():
        program = torch.export.export(module, tuple(args))
    graph = copy.deepcopy(program.graph_module).graph
    graph.eliminate_dead_code(lambda n: n.target not in _CHECKS and n.is_impure())
    return sum(node_flops(n) for n in graph.nodes)


def reference_flops(model_cfg: dict, b: int, h: int, w: int, train: bool) -> float:
    """FLOPs an image of the reference's forward at ``(h, w)`` (batch
    ``b``): serving's outputs, or with ``train`` also the FAM
    classification branch the loss reads. The weights are left empty."""
    from .reference.model import from_config
    model = from_config(model_cfg).eval()

    def fwd(x):
        out = model(x, with_fam_cls=train)
        return [t for k in ("fam_cls", "fam_bbox", "odm_cls", "odm_bbox") for t in out[k]]

    return count_fn_flops(fwd, torch.empty(b, 3, h, w)) / b
