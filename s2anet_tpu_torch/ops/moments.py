"""Per-channel moment reductions of training BatchNorm.

Counterpart of ``s2anet_tpu/ops/pallas/moments.py``: over a channels-last
``[..., C]`` tensor (every leading axis reduced), with float32 sums for
bfloat16 and float32 inputs,

* :func:`channel_moments` ``x -> (sum x, sum x^2)`` (the BN forward),
* :func:`grad_channel_sums` ``(g, x) -> (sum g, sum g*x)`` (the BN backward).

Each runs its plain version for a CPU tensor and the CUDA kernel of
``csrc/bn_moments.cu`` for a CUDA tensor. The kernel reads its input in
place, so the CUDA wrappers raise on a tensor whose ``[..., C]`` view is not
contiguous (an NCHW activation that is not channels-last): a hidden copy
would double the bytes the kernels exist to save.
"""

from __future__ import annotations

import torch

from .._ext import I, P, Kernel

MOMENTS = Kernel("bn_moments", "s2a_channel_moments", [P, P, P, P, I, I, I, I, P])
PAIR = Kernel("bn_moments", "s2a_grad_channel_sums", [P, P, P, P, P, I, I, I, I, P])

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def channel_moments_plain(x: torch.Tensor):
    xf = x.reshape(-1, x.shape[-1]).float()
    return xf.sum(0), (xf * xf).sum(0)


def grad_channel_sums_plain(g: torch.Tensor, x: torch.Tensor):
    gf = g.reshape(-1, g.shape[-1]).float()
    xf = x.reshape(-1, x.shape[-1]).float()
    return gf.sum(0), (gf * xf).sum(0)


def chunks(rows: int, c: int, dtype: torch.dtype) -> int:
    """Row chunks of the kernel's first pass: about 8 blocks of 256 threads
    per SM of an H100 (132 SMs), each thread at least 4 rows."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    nvec = c // vec
    tx = min(nvec, 32)
    ty = 256 // tx
    blocks_y = -(-nvec // tx)
    return max(1, min(-(-1056 // blocks_y), -(-rows // (4 * ty))))


def _rows_c(name: str, *ts: torch.Tensor):
    x = ts[-1]
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} takes CUDA tensors")
    if any(t.shape != x.shape or t.dtype != x.dtype for t in ts):
        raise ValueError(f"{name}: inputs differ in shape or type")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    c = x.shape[-1]
    if c % (8 if x.dtype == torch.bfloat16 else 4):
        raise ValueError(f"{name}: C = {c} is not a whole number of 16-byte vectors")
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the [..., C] input must be contiguous "
                             "(channels-last) and 16-byte aligned")
    return x.numel() // max(c, 1), c


def channel_moments_cuda(x: torch.Tensor):
    rows, c = _rows_c("channel_moments_cuda", x)
    n = chunks(rows, c, x.dtype)
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    ws = torch.empty(n, 2, c, dtype=torch.float32, device=x.device)
    MOMENTS(x.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), ws.data_ptr(),
            rows, c, n, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    return out[0], out[1]


def grad_channel_sums_cuda(g: torch.Tensor, x: torch.Tensor):
    rows, c = _rows_c("grad_channel_sums_cuda", g, x)
    n = chunks(rows, c, x.dtype)
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    ws = torch.empty(n, 2, c, dtype=torch.float32, device=x.device)
    PAIR(g.data_ptr(), x.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
         ws.data_ptr(), rows, c, n, _DTYPE_CODE[x.dtype],
         torch.cuda.current_stream(x.device).cuda_stream)
    return out[0], out[1]


def channel_moments(x: torch.Tensor):
    """Per-channel ``(sum, sum of squares)`` of ``x [..., C]``, float32 [C]."""
    if x.device.type == "cpu":
        return channel_moments_plain(x)
    return channel_moments_cuda(x)


def grad_channel_sums(g: torch.Tensor, x: torch.Tensor):
    """Per-channel ``(sum g, sum g*x)`` of ``g, x [..., C]``, float32 [C]."""
    if x.device.type == "cpu":
        return grad_channel_sums_plain(g, x)
    return grad_channel_sums_cuda(g, x)
