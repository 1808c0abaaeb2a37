"""Training BatchNorm's per-channel reductions and elementwise passes.

Counterpart of ``s2anet_tpu/ops/pallas/moments.py`` and of the jnp
expressions of ``s2anet_tpu/models/bn.py::bn_train_apply`` around it. Over a
channels-last ``[..., C]`` tensor (every leading axis reduced), with float32
statistics for bfloat16 and float32 inputs:

* :func:`channel_moments` ``x -> (sum x, sum x^2)``,
* :func:`grad_channel_sums` ``(g, x) -> (sum g, sum g*x)``,

and the BN layer built on them, in the order it runs:

* :func:`bn_stats` ``x -> (mean, var, rstd, mul = weight*rstd)``, and the
  running statistics updated in place (flax momentum ``keep``; one more
  batch tracked),
* :func:`bn_apply` ``y = cast((x - mean)*mul + bias)``,
* :func:`bn_grad` ``(g, x) -> (dgamma, dbeta, a = dbeta/n,
  b = rstd*dgamma/n)``,
* :func:`bn_dx` ``dx = cast(mul*((g - a) - (x - mean)*b))``.

Each runs its plain version for a CPU tensor and a CUDA kernel of
``csrc/bn_moments.cu`` for a CUDA tensor: the sums and their finishing
step are one entry point (``MOMENTS``, ``PAIR``), the elementwise passes
two more (``APPLY``, ``DX``). The kernels read their inputs in place, so
the CUDA wrappers raise on a tensor whose ``[..., C]`` view is not
contiguous (an NCHW activation or gradient that is not channels-last): a
hidden copy would double the bytes the kernels exist to save.
"""

from __future__ import annotations

import torch

from .._ext import F, I, P, Kernel

MOMENTS = Kernel("bn_moments", "s2a_channel_moments",
                 [P, P, P, I, I, I, I, P, P, P, P, F, F, F, P])
PAIR = Kernel("bn_moments", "s2a_grad_channel_sums", [P, P, P, P, I, I, I, I, P, P, P])
APPLY = Kernel("bn_moments", "s2a_bn_apply", [P, P, P, P, P, I, I, I, P])
DX = Kernel("bn_moments", "s2a_bn_dx", [P, P, P, P, P, P, P, I, I, I, P])

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _rows(x: torch.Tensor) -> int:
    return x.numel() // max(x.shape[-1], 1)


# ---------------------------------------------------------------- plain


def channel_moments_plain(x: torch.Tensor):
    xf = x.reshape(-1, x.shape[-1]).float()
    return xf.sum(0), (xf * xf).sum(0)


def grad_channel_sums_plain(g: torch.Tensor, x: torch.Tensor):
    gf = g.reshape(-1, g.shape[-1]).float()
    xf = x.reshape(-1, x.shape[-1]).float()
    return gf.sum(0), (gf * xf).sum(0)


def stats_from_sums(s, q, n: int, weight, running_mean, running_var, tracked,
                    eps: float, keep: float):
    """The forward's finishing step: ``(mean, var, rstd, mul)`` from the
    sums over ``n`` rows (var biased, clamped at 0); the running statistics
    become ``keep*running + (1 - keep)*batch`` in place, and the count of
    batches ``tracked`` gains one."""
    mean = s / n
    var = torch.clamp_min(q / n - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    running_mean.copy_(keep * running_mean + (1 - keep) * mean)
    running_var.copy_(keep * running_var + (1 - keep) * var)
    tracked.add_(1)
    return mean, var, rstd, weight * rstd


def grad_from_sums(sg, sgx, n: int, mean, rstd):
    """The backward's finishing step: ``(dgamma, dbeta, a, b)`` from
    ``(sum g, sum g*x)`` over ``n`` rows."""
    dgamma = (sgx - mean * sg) * rstd
    return dgamma, sg, sg / n, rstd * dgamma / n


def bn_stats_plain(x, weight, running_mean, running_var, tracked, eps: float,
                   keep: float):
    return stats_from_sums(*channel_moments_plain(x), _rows(x), weight,
                           running_mean, running_var, tracked, eps, keep)


def bn_apply_plain(x, mean, mul, bias):
    return ((x.float() - mean) * mul + bias).to(x.dtype)


def bn_grad_plain(g, x, mean, rstd):
    return grad_from_sums(*grad_channel_sums_plain(g, x), _rows(x), mean, rstd)


def bn_dx_plain(g, x, mean, mul, a, b):
    return (mul * ((g.float() - a) - (x.float() - mean) * b)).to(x.dtype)


# ---------------------------------------------------------------- CUDA


def chunks(rows: int, c: int, dtype: torch.dtype) -> int:
    """Row chunks of the sums' first pass: about 8 blocks of 256 threads
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
    return _rows(x), c


def _channel_vectors(name: str, c: int, x: torch.Tensor, *vs: torch.Tensor):
    dev = x.get_device()
    for v in vs:
        if (v.get_device() != dev or v.dtype != torch.float32 or v.shape != (c,)
                or not v.is_contiguous()):
            raise ValueError(f"{name}: per-channel vectors must be contiguous "
                             f"float32 [{c}] on {x.device}")


def _stream(t: torch.Tensor) -> int:
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # several microseconds a call, and a BN layer makes four
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _sums_buffer(rows: int, c: int, x: torch.Tensor, k: int):
    """One float32 ``[k + 2*chunks, C]`` allocation for a sums launch: its
    first ``k`` rows are the outputs, the rest the ``[chunks, 2, C]``
    workspace. Returns ``(buffer, outputs' pointer, workspace's pointer,
    chunks)``."""
    n = chunks(rows, c, x.dtype)
    buf = torch.empty(k + 2 * n, c, dtype=torch.float32, device=x.device)
    ptr = buf.data_ptr()
    return buf, ptr, ptr + 4 * k * c, n


def channel_moments_cuda(x: torch.Tensor):
    rows, c = _rows_c("channel_moments_cuda", x)
    buf, po, pw, n = _sums_buffer(rows, c, x, 2)
    MOMENTS(x.data_ptr(), po, pw, rows, c, n, _DTYPE_CODE[x.dtype],
            None, None, None, None, 0.0, 0.0, 0.0, _stream(x))
    return buf[:2].unbind(0)


def grad_channel_sums_cuda(g: torch.Tensor, x: torch.Tensor):
    rows, c = _rows_c("grad_channel_sums_cuda", g, x)
    buf, po, pw, n = _sums_buffer(rows, c, x, 2)
    PAIR(g.data_ptr(), x.data_ptr(), po, pw, rows, c, n, _DTYPE_CODE[x.dtype],
         None, None, _stream(x))
    return buf[:2].unbind(0)


def bn_stats_cuda(x, weight, running_mean, running_var, tracked, eps: float,
                  keep: float):
    rows, c = _rows_c("bn_stats_cuda", x)
    _channel_vectors("bn_stats_cuda", c, x, weight, running_mean, running_var)
    if (tracked.get_device() != x.get_device() or tracked.dtype != torch.int64
            or tracked.numel() != 1):
        raise ValueError("bn_stats_cuda: the batch count must be one int64 on the "
                         "input's device")
    buf, po, pw, n = _sums_buffer(rows, c, x, 6)
    MOMENTS(x.data_ptr(), po, pw, rows, c, n, _DTYPE_CODE[x.dtype], weight.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), tracked.data_ptr(), eps,
            keep, 1 - keep, _stream(x))
    return buf[2:6].unbind(0)


def bn_apply_cuda(x, mean, mul, bias):
    rows, c = _rows_c("bn_apply_cuda", x)
    _channel_vectors("bn_apply_cuda", c, x, mean, mul, bias)
    y = torch.empty_like(x)
    APPLY(x.data_ptr(), mean.data_ptr(), mul.data_ptr(), bias.data_ptr(), y.data_ptr(),
          rows, c, _DTYPE_CODE[x.dtype], _stream(x))
    return y


def bn_grad_cuda(g, x, mean, rstd):
    rows, c = _rows_c("bn_grad_cuda", g, x)
    _channel_vectors("bn_grad_cuda", c, x, mean, rstd)
    buf, po, pw, n = _sums_buffer(rows, c, x, 5)
    PAIR(g.data_ptr(), x.data_ptr(), po, pw, rows, c, n, _DTYPE_CODE[x.dtype],
         mean.data_ptr(), rstd.data_ptr(), _stream(x))
    dbeta, _, dgamma, a, b = buf[:5].unbind(0)
    return dgamma, dbeta, a, b


def bn_dx_cuda(g, x, mean, mul, a, b):
    rows, c = _rows_c("bn_dx_cuda", g, x)
    _channel_vectors("bn_dx_cuda", c, x, mean, mul, a, b)
    dx = torch.empty_like(x)
    DX(g.data_ptr(), x.data_ptr(), mean.data_ptr(), mul.data_ptr(), a.data_ptr(),
       b.data_ptr(), dx.data_ptr(), rows, c, _DTYPE_CODE[x.dtype], _stream(x))
    return dx


# ---------------------------------------------------------------- public


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


def bn_stats(x, weight, running_mean, running_var, tracked, eps: float, keep: float):
    """Batch statistics of ``x [..., C]``: float32 ``(mean, var, rstd, mul)``
    [C], ``mul = weight*rstd``; ``running_mean`` and ``running_var`` become
    ``keep*running + (1 - keep)*batch`` in place (biased variance), and the
    int64 count ``tracked`` gains one."""
    if x.device.type == "cpu":
        return bn_stats_plain(x, weight, running_mean, running_var, tracked, eps, keep)
    return bn_stats_cuda(x, weight, running_mean, running_var, tracked, eps, keep)


def bn_apply(x, mean, mul, bias):
    """``cast((x - mean)*mul + bias)`` over ``x [..., C]``, float32 inside."""
    if x.device.type == "cpu":
        return bn_apply_plain(x, mean, mul, bias)
    return bn_apply_cuda(x, mean, mul, bias)


def bn_grad(g, x, mean, rstd):
    """``(dgamma, dbeta, a, b)`` float32 [C] of the BN backward for the
    output gradient ``g`` and the input ``x [..., C]``."""
    if x.device.type == "cpu":
        return bn_grad_plain(g, x, mean, rstd)
    return bn_grad_cuda(g, x, mean, rstd)


def bn_dx(g, x, mean, mul, a, b):
    """``cast(mul*((g - a) - (x - mean)*b))``, the BN input gradient."""
    if x.device.type == "cpu":
        return bn_dx_plain(g, x, mean, mul, a, b)
    return bn_dx_cuda(g, x, mean, mul, a, b)
