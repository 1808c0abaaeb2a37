"""Exact analytic FLOP counting from the ``torch.export`` graph, and the
card's measured matmul rate.

Counterpart of ``s2anet_tpu/utils/flops.py``, which walks a jaxpr. Here
:func:`count_fn_flops` traces the function with ``torch.export`` (fake
tensors: nothing runs), drops the nodes that reach no output when ``dce``
is set, and sums ``2 x MACs`` from each node's static shapes over the
convolutions, the matrix products and the AlignConv custom op
(``s2anet::s2a_deform_conv2d_fwd``, counted as the JAX gather path's nine
``[B*H*W, C] x [C, Cout]`` products). Elementwise work is not counted: the
convention of the model-FLOP share (MFU) of the public literature, and of
the JAX module.

The count with ``dce=True`` is what a serving batch must compute, the MFU
numerator; with ``dce=False`` it is what the eager port executes, which
also runs graph branches no output reads (the FAM classification stack
and head at inference).
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ..ops import library  # noqa: F401  (the s2anet ops the graph may hold)

_aten = torch.ops.aten
CONVS = {_aten.convolution.default, _aten.conv2d.default, _aten._convolution.default}
MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
           _aten.baddbmm.default, _aten.matmul.default, _aten.linear.default}
DEFORM = torch.ops.s2anet.s2a_deform_conv2d_fwd.default


def _shape(node) -> tuple:
    return tuple(node.meta["val"].shape)


def node_flops(node) -> int:
    """``2 x MACs`` of one graph node (0 for a node that does no product)."""
    if node.op != "call_function":
        return 0
    t = node.target
    if t in CONVS:
        w = _shape(node.args[1])  # [Cout, Cin / groups, kh, kw]
        return 2 * math.prod(_shape(node)) * math.prod(w[1:])
    if t in MATMULS:
        a = node.args[1] if t in (_aten.addmm.default, _aten.baddbmm.default) else node.args[0]
        k = _shape(a)[-1]
        return 2 * math.prod(_shape(node)) * k
    if t == DEFORM:
        b, h, w, c = _shape(node.args[0])
        return 2 * b * h * w * c * _shape(node.args[2])[-1] * 9
    return 0


class _Fn(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


# checks that export puts beside a cast: they read a tensor and return
# nothing, so they would keep a dead branch alive
_CHECKS = {_aten._assert_tensor_metadata.default}


def _impure(node) -> bool:
    return node.target not in _CHECKS and node.is_impure()


def count_program_flops(program: torch.export.ExportedProgram, dce: bool = True) -> int:
    """Total ``2 x MACs`` of the convolutions, matrix products and
    AlignConv nodes of an exported program (``dce``: of those that reach an
    output; the program itself is left as it is)."""
    graph = copy.deepcopy(program.graph_module).graph
    if dce:
        graph.eliminate_dead_code(_impure)
    return sum(node_flops(n) for n in graph.nodes)


def count_fn_flops(fn, *args, dce: bool = True) -> int:
    """FLOPs of ``fn(*args)`` (a module or a function) by tracing it with
    ``torch.export``, without gradients (no compute).

    With ``dce=True`` (the default) nodes that contribute to no output are
    dropped first, as XLA drops them in the JAX package: at inference the
    FAM classification branch is dead and must not inflate the MFU."""
    module = fn if isinstance(fn, nn.Module) else _Fn(fn)
    with torch.no_grad():
        program = torch.export.export(module, tuple(args))
    return count_program_flops(program, dce)


def measure_matmul_peak(dtype=torch.bfloat16, k: int = 4096, iters: int = 32,
                        repeats: int = 3) -> float:
    """The card's measured matmul rate (FLOP/s) on ``[k, k] x [k, k]``
    products of ``dtype``: CUDA events around chains of ``iters`` and
    ``3 * iters`` products after a warm-up, differenced so that the launch
    overhead cancels; the best of ``repeats``. A plain ``torch.mm`` is the
    yardstick of the MFU denominator, not a kernel of the port."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_matmul_peak needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(k, k, device="cuda", generator=gen).to(dtype) / math.sqrt(k)
    b = torch.randn(k, k, device="cuda", generator=gen).to(dtype)
    out = torch.empty(k, k, device="cuda", dtype=dtype)

    def chain(n: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            torch.mm(a, b, out=out)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1000

    n0, n1 = iters, 3 * iters
    chain(n0)  # warm-up: cuBLAS's heuristics, clocks
    best = min(chain(n1) - chain(n0) for _ in range(repeats))
    return (n1 - n0) * 2 * k ** 3 / best


def mfu(flops_per_item: float, items_per_s: float, peak_flop_s: float) -> float:
    """The model-FLOP share: the model's FLOP rate over the peak."""
    return flops_per_item * items_per_s / peak_flop_s
