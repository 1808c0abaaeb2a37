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
step are one launch (``MOMENTS``, ``PAIR``; grid from :func:`sums_plan`),
the elementwise passes two more (``APPLY``, ``DX``). The kernels read their
inputs in place, so the CUDA wrappers raise on a tensor whose ``[..., C]``
view is not contiguous (an NCHW activation or gradient that is not
channels-last): a hidden copy would double the bytes the kernels exist to
save.
"""

from __future__ import annotations

import ctypes

import torch

from .._ext import F, I, P, Kernel, library

MOMENTS = Kernel("bn_moments", "s2a_channel_moments",
                 [P, P, P, P, I, I, I, I, P, P, P, P, F, F, F, P])
PAIR = Kernel("bn_moments", "s2a_grad_channel_sums", [P, P, P, P, P, I, I, I, I, P, P, P])
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


CLUSTER = 8  # blocks per cluster of the sums kernel, along the rows
TICKET_SLOTS = 1024  # ticket counters per device: the channel groups a launch may have


def sums_rows(pair: bool) -> int:
    """Rows in flight per thread of the sums kernel (``R`` in
    ``csrc/bn_moments.cu::channel_sums``): two inputs in the pair kernel."""
    return 2 if pair else 4


def sums_plan(rows: int, c: int, dtype: torch.dtype, wave: int, pair: bool = False):
    """The sums kernel's grid over ``[rows, c]``: ``(chunks, groups)``.
    Blocks of 256 threads walk the 16-byte channel vectors (up to 32 a
    block: ``groups`` blocks across the channels) and the rows in tiles of
    :func:`sums_rows` rows a thread; tile ``t`` falls to block ``t %
    chunks``. ``chunks x groups`` blocks fill at most one resident wave of
    ``wave`` blocks, chunks come in whole clusters of :data:`CLUSTER`, and
    every cluster has a tile."""
    nvec = c // (8 if dtype == torch.bfloat16 else 4)
    tx = min(nvec, 32)
    groups = -(-nvec // tx)
    fill = max(1, wave // groups // CLUSTER) * CLUSTER
    tiles = max(1, _ceil(rows, sums_rows(pair) * (256 // tx)))
    return min(fill, _ceil(tiles, CLUSTER) * CLUSTER), groups


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def workspace_floats(chunks: int, c: int) -> int:
    """float32 scratch of a sums launch: one ``[2, c]`` partial a cluster."""
    return chunks // CLUSTER * 2 * c


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


_WAVE: dict = {}     # (device, dtype, pair) -> blocks of one resident wave
_TICKETS: dict = {}  # device -> uint32 tickets, zero between launches
_PLANS: dict = {}    # (device, dtype, pair, rows, c) -> (chunks, workspace rows, tickets)


def _wave(x: torch.Tensor, pair: bool) -> int:
    key = (x.device.index, x.dtype, pair)
    if key not in _WAVE:
        lib = library("bn_moments")
        lib.s2a_sums_wave.argtypes = [I, I, P]
        lib.s2a_sums_wave.restype = ctypes.c_int
        n = ctypes.c_int(0)
        with torch.cuda.device(x.device):
            rc = lib.s2a_sums_wave(_DTYPE_CODE[x.dtype], int(pair), ctypes.byref(n))
        if rc != 0 or n.value < CLUSTER:
            raise RuntimeError(f"s2a_sums_wave failed: cudaError {rc}, {n.value} blocks")
        _WAVE[key] = n.value
    return _WAVE[key]


def _tickets(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The device's ticket counters, one per channel group. Every launch
    leaves them zero, so one buffer, allocated once, serves all calls and
    CUDA-graph replays on the device; sums launches on one device must not
    run concurrently (on two streams at once)."""
    if groups > TICKET_SLOTS:
        raise ValueError(f"the sums kernel takes at most {TICKET_SLOTS} channel groups")
    t = _TICKETS.get(x.device.index)
    if t is None:
        t = _TICKETS[x.device.index] = torch.zeros(TICKET_SLOTS, dtype=torch.int32,
                                                   device=x.device)
    return t


def _sums_buffer(rows: int, c: int, x: torch.Tensor, k: int, pair: bool):
    """One float32 ``[k + 2*chunks/8, C]`` allocation for a sums launch: its
    first ``k`` rows are the outputs, the rest the workspace. Returns
    ``(buffer, outputs' pointer, workspace's pointer, tickets' pointer,
    chunks)``. The plan is worked out once per shape."""
    key = (x.device.index, x.dtype, pair, rows, c)
    plan = _PLANS.get(key)
    if plan is None:
        chunks, groups = sums_plan(rows, c, x.dtype, _wave(x, pair), pair)
        plan = _PLANS[key] = (chunks, workspace_floats(chunks, c) // c,
                              _tickets(x, groups).data_ptr())
    chunks, ws_rows, tickets = plan
    buf = torch.empty(k + ws_rows, c, dtype=torch.float32, device=x.device)
    ptr = buf.data_ptr()
    return buf, ptr, ptr + 4 * k * c, tickets, chunks


def channel_moments_cuda(x: torch.Tensor):
    rows, c = _rows_c("channel_moments_cuda", x)
    buf, po, pw, pt, n = _sums_buffer(rows, c, x, 2, False)
    MOMENTS(x.data_ptr(), po, pw, pt, rows, c, n, _DTYPE_CODE[x.dtype],
            None, None, None, None, 0.0, 0.0, 0.0, _stream(x))
    return buf[:2].unbind(0)


def grad_channel_sums_cuda(g: torch.Tensor, x: torch.Tensor):
    rows, c = _rows_c("grad_channel_sums_cuda", g, x)
    buf, po, pw, pt, n = _sums_buffer(rows, c, x, 2, True)
    PAIR(g.data_ptr(), x.data_ptr(), po, pw, pt, rows, c, n, _DTYPE_CODE[x.dtype],
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
    buf, po, pw, pt, n = _sums_buffer(rows, c, x, 6, False)
    MOMENTS(x.data_ptr(), po, pw, pt, rows, c, n, _DTYPE_CODE[x.dtype], weight.data_ptr(),
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
    buf, po, pw, pt, n = _sums_buffer(rows, c, x, 5, True)
    PAIR(g.data_ptr(), x.data_ptr(), po, pw, pt, rows, c, n, _DTYPE_CODE[x.dtype],
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
