"""AlignConv: analytic offsets and the 3x3 deformable convolution (NHWC).

Counterpart of ``s2anet_tpu/ops/deform_conv.py`` (``align_conv_offsets``,
the gather-path forward) and of the TPU kernel
``s2anet_tpu/ops/pallas/deform_kernel.py::_fwd_kernel``, whose port is
``csrc/deform_conv.cu``.

Layouts follow the JAX package: x ``[B, H, W, C]``, offsets
``[B, H, W, 9, 2]`` as (dy, dx) with tap ``t = ky*3 + kx``, weight
``[3, 3, C, Cout]`` (HWIO). Only stride 1, 'same' padding, dilation 1 and one
deformable group -- the configuration AlignConv uses.

:func:`deform_conv2d` runs :func:`deform_conv2d_plain` for a CPU tensor and
the CUDA kernel for a CUDA tensor; it never moves work between devices.
"""

from __future__ import annotations

import torch

from .._ext import I, P, Kernel

DEFORM_FWD = Kernel("deform_conv", "s2a_deform_conv2d_fwd",
                    [P, P, P, P, I, I, I, I, I, I, P])

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def align_conv_offsets(anchors: torch.Tensor, featmap_size, stride: float,
                       kernel_size: int = 3) -> torch.Tensor:
    """Deformable offsets that sample each refined anchor's rotated grid.

    The anchor's (w, h) are scaled down to the k x k window and the standard
    grid is rotated by the anchor angle; the offset is that position minus
    the standard grid position.

    Args:
      anchors: ``[B, H*W, 5]`` refined anchors (image pixels / radians).
      featmap_size: (H, W) of the level.
      stride: the level's downsample factor.

    Returns:
      ``[B, H, W, k*k, 2]`` (dy, dx) offsets.
    """
    h, w = featmap_size
    k = kernel_size
    pad = (k - 1) // 2
    dtype, device = anchors.dtype, anchors.device
    idx = torch.arange(-pad, pad + 1, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(idx, idx, indexing="ij")
    xx = xx.reshape(-1)
    yy = yy.reshape(-1)
    yc, xc = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    x_conv = xc.reshape(-1)[:, None] + xx[None, :]  # [H*W, k*k]
    y_conv = yc.reshape(-1)[:, None] + yy[None, :]

    x_ctr, y_ctr, aw, ah, a = anchors.unbind(-1)
    x_ctr, y_ctr = x_ctr / stride, y_ctr / stride
    aw, ah = aw / stride, ah / stride
    cos, sin = torch.cos(a)[..., None], torch.sin(a)[..., None]
    xk = (aw / k)[..., None] * xx
    yk = (ah / k)[..., None] * yy
    x_anchor = cos * xk - sin * yk + x_ctr[..., None]
    y_anchor = sin * xk + cos * yk + y_ctr[..., None]
    off = torch.stack([y_anchor - y_conv, x_anchor - x_conv], -1)
    return off.reshape(anchors.shape[0], h, w, k * k, 2)


def _bilinear_tap(x: torch.Tensor, py: torch.Tensor,
                  px: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear samples of ``x [B, H, W, C]`` (float32) at
    float32 positions ``[B, H, W]`` -> ``[B, H*W, C]`` float32."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ly, lx = py - y0, px - x0
    out = torch.zeros(b, h * w, c, dtype=torch.float32, device=x.device)
    for dy, wy in ((0, 1.0 - ly), (1, ly)):
        for dx, wx in ((0, 1.0 - lx), (1, lx)):
            yi, xi = y0 + dy, x0 + dx
            inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
            wgt = torch.where(inside, wy * wx, 0.0).reshape(b, -1, 1)
            out += wgt * vals
    return out


def deform_conv2d_plain(x: torch.Tensor, offsets: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch AlignConv forward: 9 taps of bilinear sampling, each
    followed by a product with that tap's ``[C, Cout]`` weight.

    Same numerics contract as the kernel: float32 coordinates, samples
    rounded to ``x.dtype``, float32 accumulation, output in ``x.dtype``.
    """
    b, h, w, c = x.shape
    cout = weight.shape[-1]
    xf = x.float()
    w_taps = weight.reshape(9, c, cout).float()
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    off = offsets.float()
    acc = torch.zeros(b * h * w, cout, dtype=torch.float32, device=x.device)
    for t in range(9):
        py = gy + (t // 3 - 1) + off[..., t, 0]
        px = gx + (t % 3 - 1) + off[..., t, 1]
        s = _bilinear_tap(xf, py, px).to(x.dtype).float()
        acc += s.reshape(b * h * w, c) @ w_taps[t]
    return acc.reshape(b, h, w, cout).to(x.dtype)


def deform_conv2d_cuda(x: torch.Tensor, offsets: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (``csrc/deform_conv.cu``) on CUDA tensors."""
    if not (x.is_cuda and offsets.is_cuda and weight.is_cuda):
        raise ValueError("deform_conv2d_cuda takes CUDA tensors")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"deform_conv2d_cuda: unsupported dtype {x.dtype}")
    b, h, w, c = x.shape
    if weight.shape[:3] != (3, 3, c) or offsets.shape != (b, h, w, 9, 2):
        raise ValueError(
            f"deform_conv2d_cuda: shapes x {tuple(x.shape)}, offsets "
            f"{tuple(offsets.shape)}, weight {tuple(weight.shape)}")
    cout = weight.shape[-1]
    if x.dtype == torch.bfloat16 and (c % 8 or cout % 8):
        raise ValueError("deform_conv2d_cuda: bfloat16 needs C and Cout "
                         f"multiples of 8, got {c} and {cout}")
    x = x.contiguous()
    weight = weight.to(x.dtype).contiguous()
    # the bf16 kernel reads 16-byte vectors: a view may start off-alignment
    x, weight = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, weight))
    offsets = offsets.float().contiguous()
    out = torch.empty(b, h, w, cout, dtype=x.dtype, device=x.device)
    DEFORM_FWD(x.data_ptr(), offsets.data_ptr(), weight.data_ptr(),
               out.data_ptr(), b, h, w, c, cout, _DTYPE_CODE[x.dtype],
               torch.cuda.current_stream(x.device).cuda_stream)
    return out


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """3x3 deformable conv, NHWC: the plain version for a CPU tensor, the
    CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offsets, weight)
    return deform_conv2d_cuda(x, offsets, weight)
