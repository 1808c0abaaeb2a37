"""The serving kernels as ``torch.library`` custom ops, namespace ``s2anet``.

* ``s2anet::s2a_deform_conv2d_fwd(x, offsets, weight) -> out``: the
  AlignConv forward (``ops/deform_conv.py``);
* ``s2anet::s2a_nms_rotated_mask(boxes, labels, valid, iou_thr) -> mask``:
  the suppression bitmask ``[B, K, ceil(K/64)]`` int64 of score-sorted
  candidates (``ops/nms_rotated.py``);
* ``s2anet::s2a_nms_rotated_sweep(mask, valid) -> keep``: the greedy keep
  ``[B, K]`` bool over that mask.

Each op runs its CUDA kernel's wrapper on a CUDA tensor and the kernel's
plain version on a CPU tensor, and has a fake (shape-only) version, so
that ``torch.export`` traces the serving path with the three ops as single
nodes of its graph on either device, and a flop counter or a profiler sees
them by name. :func:`.deform_conv.deform_conv2d` (without gradients) and
:func:`.nms_rotated.nms_keep` call them.

An exported program reloads with this module imported and nothing else of
the package's models::

    import s2anet_tpu_torch.ops.library  # registers the ops
    program = torch.export.load("s2anet.pt2").module()

Importing :mod:`s2anet_tpu_torch.ops` imports this module, so every
caller of the wrappers has the ops registered. The training path's
AlignConv (forward and backward kernels under autograd) does not go
through the op, and neither does the int8, IoU or BatchNorm kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from . import deform_conv as dc
from . import nms_rotated as nms


@torch.library.custom_op("s2anet::s2a_deform_conv2d_fwd", mutates_args=(), device_types="cpu")
def deform_conv2d_fwd(x: torch.Tensor, offsets: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """AlignConv forward: x ``[B, H, W, C]``, offsets ``[B, H, W, 9, 2]``,
    weight ``[3, 3, C, Cout]`` -> ``[B, H, W, Cout]`` in x's type."""
    return dc.deform_conv2d_plain(x, offsets, weight)


@deform_conv2d_fwd.register_kernel("cuda")
def _(x, offsets, weight):
    return dc.deform_conv2d_cuda(x, offsets, weight)


@deform_conv2d_fwd.register_fake
def _(x, offsets, weight):
    b, h, w, _ = x.shape
    return x.new_empty(b, h, w, weight.shape[-1])


def _words(k: int) -> int:
    return (k + 63) // 64


def pack_bits(over: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, n, n]`` bool -> ``[B, k, ceil(k/64)]`` int64 words, bit
    ``j % 64`` of word ``j // 64`` of row ``i`` set where ``over[:, i, j]``
    (rows and columns past ``n`` clear): the kernel's mask layout."""
    b, n, _ = over.shape
    bits = np.zeros((b, n, _words(k) * 64), dtype=bool)
    bits[:, :, :n] = over.cpu().numpy()
    words = np.packbits(bits, axis=-1, bitorder="little").view("<i8")
    mask = torch.zeros(b, k, _words(k), dtype=torch.int64)
    mask[:, :n] = torch.from_numpy(words)
    return mask.to(over.device)


def unpack_bits(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` on the first ``n`` rows and columns."""
    words = np.ascontiguousarray(mask[:, :n].cpu().numpy())
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return torch.from_numpy(bits[:, :, :n].astype(bool)).to(mask.device)


@torch.library.custom_op("s2anet::s2a_nms_rotated_mask", mutates_args=(), device_types="cpu")
def nms_rotated_mask(boxes: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                     iou_thr: float) -> torch.Tensor:
    """Suppression bitmask of score-sorted candidates ``boxes [B, K, 5]``,
    ``labels [B, K]``, ``valid [B, K]``: row ``i`` sets bit ``j`` when
    ``j > i``, both are valid, their labels are equal and their IoU >
    ``iou_thr``. The CUDA kernel writes only the words of valid rows from
    the row's own word on (the sweep reads no other); the plain version
    writes every word."""
    b, k = valid.shape
    n = nms.last_valid(valid)
    if n == 0:
        return torch.zeros(b, k, _words(k), dtype=torch.int64, device=boxes.device)
    return pack_bits(nms.overlap_plain(boxes, labels, valid, iou_thr, n), k)


@nms_rotated_mask.register_kernel("cuda")
def _(boxes, labels, valid, iou_thr):
    return nms.nms_mask_cuda(boxes, labels, valid, iou_thr)


@nms_rotated_mask.register_fake
def _(boxes, labels, valid, iou_thr):
    b, k = valid.shape
    return boxes.new_empty(b, k, _words(k), dtype=torch.int64)


@torch.library.custom_op("s2anet::s2a_nms_rotated_sweep", mutates_args=(), device_types="cpu")
def nms_rotated_sweep(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy keep ``[B, K]`` over the bitmask: rows in order, a row still
    alive removes the later rows it overlaps; invalid rows are not kept."""
    alive = valid.to(torch.bool).clone()
    n = nms.last_valid(valid)
    if n:
        alive[:, :n] = nms.sweep_plain(unpack_bits(mask, n), alive[:, :n])
    return alive


@nms_rotated_sweep.register_kernel("cuda")
def _(mask, valid):
    return nms.nms_sweep_cuda(mask, valid)


@nms_rotated_sweep.register_fake
def _(mask, valid):
    return valid.new_empty(valid.shape, dtype=torch.bool)
