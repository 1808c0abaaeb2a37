"""AlignConv: analytic offsets and the 3x3 deformable convolution (NHWC).

Counterpart of ``s2anet_tpu/ops/deform_conv.py`` (``align_conv_offsets``,
the gather path) and of the TPU kernels
``s2anet_tpu/ops/pallas/deform_kernel.py::_fwd_kernel`` and ``_bwd_kernel``,
whose ports are the two entry points of ``csrc/deform_conv.cu``.

Layouts follow the JAX package: x ``[B, H, W, C]``, offsets
``[B, H, W, 9, 2]`` as (dy, dx) with tap ``t = ky*3 + kx``, weight
``[3, 3, C, Cout]`` (HWIO). Only stride 1, 'same' padding, dilation 1 and one
deformable group -- the configuration AlignConv uses.

:func:`deform_conv2d` without gradients (serving) runs the custom op
``s2anet::s2a_deform_conv2d_fwd`` (``ops/library.py``): the forward kernel
for a CUDA tensor, :func:`deform_conv2d_plain` for a CPU tensor. Where a
gradient is wanted (training) it runs :func:`deform_conv2d_plain` for a CPU
tensor, differentiated by autograd, and for a CUDA tensor the forward
kernel inside an ``autograd.Function`` whose backward is the backward
kernel. It never moves work between devices. The offsets get no gradient
on the kernel path: AlignConv derives them from detached anchors, as the
TPU kernel's VJP (``_hat_core_bwd``) assumes.
"""

from __future__ import annotations

import torch

from .._ext import I, P, Kernel

DEFORM_FWD = Kernel("deform_conv", "s2a_deform_conv2d_fwd",
                    [P, P, P, P, I, I, I, I, I, I, P])
DEFORM_BWD = Kernel("deform_conv", "s2a_deform_conv2d_bwd",
                    [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P])

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def align_conv_offsets(anchors: torch.Tensor, featmap_size, stride: float,
                       kernel_size: int = 3, row0: int = 0) -> torch.Tensor:
    """Deformable offsets that sample each refined anchor's rotated grid.

    The anchor's (w, h) are scaled down to the k x k window and the standard
    grid is rotated by the anchor angle; the offset is that position minus
    the standard grid position.

    Args:
      anchors: ``[B, H*W, 5]`` refined anchors (image pixels / radians).
      featmap_size: (H, W) of the level.
      stride: the level's downsample factor.
      row0: the map's first row in a taller map (one rank's rows of a
        height-sharded image): the offsets are those rows' of the taller
        map, computed from the same absolute grid rows.

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
    yc, xc = torch.meshgrid(torch.arange(row0, row0 + h, dtype=dtype, device=device),
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


def deform_conv2d_bwd_plain(x: torch.Tensor, offsets: torch.Tensor,
                            weight: torch.Tensor, grad: torch.Tensor):
    """Plain PyTorch AlignConv backward: ``(dx, dweight)`` by autograd of
    :func:`deform_conv2d_plain` (offsets held constant), the reference of
    the backward kernel."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        wr = weight.detach().requires_grad_(True)
        out = deform_conv2d_plain(xr, offsets.detach(), wr)
        dx, dw = torch.autograd.grad(out, (xr, wr), grad)
    return dx, dw


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary (the bf16 kernels read
    16-byte vectors; a view may start off-alignment)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(name: str, x: torch.Tensor, offsets: torch.Tensor,
           weight: torch.Tensor, *more: torch.Tensor) -> None:
    if not all(t.is_cuda for t in (x, offsets, weight, *more)):
        raise ValueError(f"{name} takes CUDA tensors")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    b, h, w, c = x.shape
    if weight.shape[:3] != (3, 3, c) or offsets.shape != (b, h, w, 9, 2):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, offsets "
            f"{tuple(offsets.shape)}, weight {tuple(weight.shape)}")
    cout = weight.shape[-1]
    if x.dtype == torch.bfloat16 and (c % 8 or cout % 8):
        raise ValueError(f"{name}: bfloat16 needs C and Cout multiples of 8, "
                         f"got {c} and {cout}")


def deform_conv2d_cuda(x: torch.Tensor, offsets: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """The forward kernel (``csrc/deform_conv.cu``) on CUDA tensors."""
    _check("deform_conv2d_cuda", x, offsets, weight)
    b, h, w, c = x.shape
    cout = weight.shape[-1]
    x = _aligned(x)
    weight = _aligned(weight.to(x.dtype))
    offsets = _aligned(offsets.float())
    out = torch.empty(b, h, w, cout, dtype=x.dtype, device=x.device)
    DEFORM_FWD(x.data_ptr(), offsets.data_ptr(), weight.data_ptr(),
               out.data_ptr(), b, h, w, c, cout, _DTYPE_CODE[x.dtype],
               torch.cuda.current_stream(x.device).cuda_stream)
    return out


SMS = 132  # streaming multiprocessors of an H100 SXM


def dw_plan(cells: int, c: int, cout: int, dtype: torch.dtype) -> tuple[int, int]:
    """``(chunks, cells per chunk)`` of the weight-gradient kernel.

    bfloat16: a block owns one tap, 128 input channels, 256 output channels
    and one chunk, and writes its own slice of a ``[chunks, 9, C, Cout]``
    workspace, so the chunks are as many as fill one wave of the SMs; each
    chunk holds whole 64-cell steps. float32: about 4 blocks per SM of
    64 x 256 channels, each adding its tile into dW once; 32-cell steps.
    The last chunk may be short; every chunk holds at least one cell.
    """
    if dtype == torch.bfloat16:
        step = 64
        tiles = 9 * -(-c // 128) * -(-cout // 256)
        want = SMS // tiles
    else:
        step = 32
        tiles = 9 * -(-c // 64) * -(-cout // 256)
        want = -(-4 * SMS // tiles)
    want = max(1, min(want, -(-cells // step)))
    per = -(-cells // want)
    chunk = -(-per // step) * step
    return -(-cells // chunk), chunk


def deform_conv2d_bwd_cuda(x: torch.Tensor, offsets: torch.Tensor,
                           weight: torch.Tensor, grad: torch.Tensor):
    """The backward kernel on CUDA tensors: ``(dx, dweight)`` of the
    forward's output gradient ``grad [B, H, W, Cout]``; ``dx`` in x's type,
    ``dweight [3, 3, C, Cout]`` in weight's type (both summed in float32)."""
    _check("deform_conv2d_bwd_cuda", x, offsets, weight, grad)
    b, h, w, c = x.shape
    cout = weight.shape[-1]
    if grad.shape != (b, h, w, cout):
        raise ValueError(f"deform_conv2d_bwd_cuda: grad {tuple(grad.shape)}, "
                         f"want {(b, h, w, cout)}")
    x = _aligned(x)
    wt = _aligned(weight.to(x.dtype))
    grad = _aligned(grad.to(x.dtype))
    offsets = _aligned(offsets.float())
    chunks, chunk = dw_plan(b * h * w, c, cout, x.dtype)
    dev = x.device
    f32 = x.dtype == torch.float32
    dw = torch.empty(3, 3, c, cout, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    # bf16: float32 sums of dx, and each chunk's dW
    dx32 = dx if f32 else torch.empty(b, h, w, c, dtype=torch.float32, device=dev)
    ws = None if f32 else torch.empty(chunks, 9, c, cout, dtype=torch.float32, device=dev)
    DEFORM_BWD(x.data_ptr(), offsets.data_ptr(), wt.data_ptr(), grad.data_ptr(),
               dx32.data_ptr(), dx.data_ptr(), dw.data_ptr(),
               None if ws is None else ws.data_ptr(), b, h, w, c, cout,
               chunks, chunk, _DTYPE_CODE[x.dtype],
               torch.cuda.current_stream(dev).cuda_stream)
    return dx, dw.to(weight.dtype)


class _DeformConvCUDA(torch.autograd.Function):
    """Forward and backward kernels; the offsets get no gradient."""

    @staticmethod
    def forward(ctx, x, offsets, weight):
        ctx.save_for_backward(x, offsets, weight)
        return deform_conv2d_cuda(x, offsets, weight)

    @staticmethod
    def backward(ctx, grad):
        x, offsets, weight = ctx.saved_tensors
        dx, dw = deform_conv2d_bwd_cuda(x, offsets, weight, grad)
        return dx, None, dw


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """3x3 deformable conv, NHWC: the plain version for a CPU tensor, the
    CUDA kernels for a CUDA tensor; without gradients through the custom
    op."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (x, offsets, weight))):
        return torch.ops.s2anet.s2a_deform_conv2d_fwd(x, offsets, weight)
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offsets, weight)
    return _DeformConvCUDA.apply(x, offsets, weight)
