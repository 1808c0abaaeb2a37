"""Layers on one rank's rows of a height-sharded image: the halos GSPMD
inserts for the JAX package's spatial mode.

``s2anet_tpu/parallel/spatial.py`` jits the whole detector on an image
whose height is sharded over the mesh, and XLA's partitioner puts a halo
exchange around every convolution. Here the ranks are processes
(``parallel/mesh.py``) and the layers fetch their halos themselves while
:class:`sharded` is active, which :mod:`.spatial` enters around the model's
forward on N > 1 ranks; with one rank nothing here runs. Every rank holds
as many rows, and its first row is a multiple of 128, the largest stride.

* :func:`conv2d` and :func:`max_pool2d`: for kernel k, stride s and padding
  p, the previous rank's last p rows and the next rank's first
  ``max(k - p - s, 0)``, then the op with height padding 0 and the same
  width padding. 1x1 convs fetch nothing.
* :func:`first_row`: the rank's first row at a level, so that anchors and
  AlignConv offsets are computed in absolute rows (``models/head.py``).
* :func:`deform_rows`: the counterpart of ``_spatial_hat``
  (``s2anet_tpu/models/head.py:44-89``) around the AlignConv kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import mesh

_active = False


class sharded:
    """``with sharded():`` the layers run on this rank's rows while it is
    active, when the group has more than one rank."""

    def __enter__(self):
        global _active
        self.before = _active
        _active = mesh.world_size() > 1
        return self

    def __exit__(self, *exc):
        global _active
        _active = self.before
        return False


def first_row(h: int) -> int:
    """The first row of this rank's ``h`` rows of a level in the whole
    map; 0 unless sharded."""
    return mesh.rank() * h if _active else 0


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _extend(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """``x [B, C, h, W]`` with the neighbours' ``top`` rows above and
    ``bottom`` rows below, channels-last (the exchange runs on the NHWC
    view, which is ``x`` itself when ``x`` is channels-last)."""
    xh = x.permute(0, 2, 3, 1)
    above, below = mesh.halo_rows(xh, top, bottom, 1)
    return torch.cat([above, xh, below], 1).permute(0, 3, 1, 2)


def _halo(k: int, s: int, p: int, h: int):
    if h % s:
        raise ValueError(f"a shard of {h} rows under stride {s}")
    return p, max(k - p - s, 0)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias, stride=1, padding=0,
           dilation=1, groups=1) -> torch.Tensor:
    """``F.conv2d``; while :class:`sharded` is active, on this rank's rows
    (zero rows past the image's edges: the conv's own zero padding)."""
    if not _active:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    if _pair(dilation) != (1, 1):
        raise NotImplementedError("a dilated conv on sharded rows")
    (sh, _), (ph, pw) = _pair(stride), _pair(padding)
    top, bottom = _halo(weight.shape[2], sh, ph, x.shape[2])
    if top or bottom:
        x = _extend(x, top, bottom)
    return F.conv2d(x, weight, bias, stride, (0, pw), 1, groups)


def max_pool2d(x: torch.Tensor, kernel_size, stride, padding) -> torch.Tensor:
    """``F.max_pool2d``; while :class:`sharded` is active, on this rank's
    rows. Past the image's edges the rows are zeros, not the pool's -inf:
    the same maxima for the stem's pool, whose input follows a ReLU (every
    value >= 0) and whose every window holds a real row."""
    if not _active:
        return F.max_pool2d(x, kernel_size, stride, padding)
    (kh, _), (sh, _), (ph, pw) = _pair(kernel_size), _pair(stride), _pair(padding)
    top, bottom = _halo(kh, sh, ph, x.shape[2])
    return F.max_pool2d(_extend(x, top, bottom), kernel_size, stride, (0, pw))


def deform_rows(fn, x: torch.Tensor, offsets: torch.Tensor, clamp: float) -> torch.Tensor:
    """``fn(x, offsets)`` (the AlignConv's 3x3 deformable conv, NHWC: x
    ``[B, h, W, C]``, offsets ``[B, h, W, 9, 2]``); while :class:`sharded`
    is active, this rank's output rows of the whole level's.

    With offsets clamped to ``clamp`` > 0 cells an output row samples rows
    within ``clamp + 2`` of its own (tap reach 1, bilinear support 1), so
    the kernel runs on x with ``ceil(clamp) + 2`` rows of each neighbour
    above and below, those rows' offsets zero, and their outputs are
    dropped; past the image's edges the rows are zeros, the kernel's own
    zero padding. A shard no taller than that halo, or unclamped offsets
    (unbounded reach), gathers x and the offsets whole and keeps this
    rank's rows of the whole level's output."""
    if not _active:
        return fn(x, offsets)
    h = x.shape[1]
    halo = math.ceil(clamp) + 2
    if clamp > 0 and h > halo:
        above, below = mesh.halo_rows(x, halo, halo, 1)
        x_ext = torch.cat([above, x, below], 1)
        off_ext = F.pad(offsets, (0, 0, 0, 0, 0, 0, halo, halo))
        return fn(x_ext, off_ext)[:, halo:halo + h]
    whole = fn(mesh.gather_rows(x, 1), mesh.gather_rows(offsets, 1))
    return whole[:, mesh.rank() * h:(mesh.rank() + 1) * h]
