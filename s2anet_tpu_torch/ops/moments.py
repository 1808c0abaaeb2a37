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

Sampled statistics (``bn_stats_images``, the JAX ``SampledBatchNorm``) run
the same four: :func:`bn_stats` on the first images' rows (contiguous in
channels-last ``[N, H, W, C]``), :func:`bn_apply` on all rows,
:func:`bn_grad` on all rows with ``n`` the rows the statistics came from,
and :func:`bn_dx` once on those rows and once, with ``a = b = 0``, on the
rest, written into one output (``out``).

Data-parallel training (``models/bn.py`` with a process group) splits the
sums from their finishing step, to add the sums over the ranks between
them: :func:`moment_sums` and :func:`pair_sums` give the ``[2, C]`` sums
alone (zeros over no rows), and the elementwise pass finishes the
all-reduced sums itself, with ``n`` the global row count:

* :func:`bn_apply_finish` ``(x, sums) -> y`` and the statistics, as
  :func:`bn_stats`'s finishing step followed by :func:`bn_apply`,
* :func:`bn_dx_finish` ``(g, x, sums) -> (dx, dgamma, dbeta)``, as
  :func:`bn_grad`'s finishing step followed by :func:`bn_dx` on the rows
  below ``stat_rows`` and :func:`bn_dx` with ``a = b = 0`` on the rest.

Each runs its plain version for a CPU tensor and a CUDA kernel of
``csrc/bn_moments.cu`` for a CUDA tensor: the sums and their finishing
step are one launch (``MOMENTS``, ``PAIR``; grid from :func:`sums_plan`),
the elementwise passes two more (``APPLY``, ``DX``); across ranks the sums
kernel runs without its finishing step, and ``APPLY_FINISH`` and
``DX_FINISH`` finish inside the elementwise pass: one launch a layer and
direction after the all-reduce, as ``APPLY`` and ``DX`` in one process.
The kernels read their inputs in place, so the CUDA wrappers raise on a
tensor whose ``[..., C]`` view is not contiguous (an NCHW activation or
gradient that is not channels-last): a hidden copy would double the bytes
the kernels exist to save.
"""

from __future__ import annotations

import ctypes

import torch

from .._ext import F, I, P, Kernel, library

MOMENTS = Kernel("bn_moments", "s2a_channel_moments",
                 [P, P, P, P, I, I, I, I, P, P, P, P, F, F, F, P])
PAIR = Kernel("bn_moments", "s2a_grad_channel_sums",
              [P, P, P, P, P, I, I, I, I, P, P, I, P])
APPLY = Kernel("bn_moments", "s2a_bn_apply", [P, P, P, P, P, I, I, I, P])
DX = Kernel("bn_moments", "s2a_bn_dx", [P, P, P, P, P, P, P, I, I, I, P])
APPLY_FINISH = Kernel("bn_moments", "s2a_bn_apply_finish",
                      [P, P, P, P, P, P, P, P, P, I, I, I, I, F, F, F, P])
DX_FINISH = Kernel("bn_moments", "s2a_bn_dx_finish", [P, P, P, P, P, P, P, P, I, I, I, I, I, P])

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
    ``(sum g, sum g*x)``, for statistics taken over ``n`` rows."""
    dgamma = (sgx - mean * sg) * rstd
    return dgamma, sg, sg / n, rstd * dgamma / n


def moment_sums_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.stack(channel_moments_plain(x))


def pair_sums_plain(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.stack(grad_channel_sums_plain(g, x))


def bn_finish_stats_plain(sums, n: int, weight, running_mean, running_var, tracked,
                          eps: float, keep: float):
    return stats_from_sums(sums[0], sums[1], n, weight, running_mean, running_var,
                           tracked, eps, keep)


def bn_finish_grad_plain(sums, n: int, mean, rstd):
    return grad_from_sums(sums[0], sums[1], n, mean, rstd)


def bn_apply_finish_plain(x, sums, n: int, weight, bias, running_mean, running_var, tracked,
                          eps: float, keep: float):
    stats = bn_finish_stats_plain(sums, n, weight, running_mean, running_var, tracked, eps,
                                  keep)
    return bn_apply_plain(x, stats[0], stats[3], bias), stats


def bn_dx_finish_plain(g, x, sums, n: int, mean, rstd, mul, stat_rows: int):
    dgamma, dbeta, a, b = bn_finish_grad_plain(sums, n, mean, rstd)
    c = x.shape[-1]
    g2, x2 = g.reshape(-1, c), x.reshape(-1, c)
    dx = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    zero = torch.zeros_like(a)
    bn_dx_plain(g2[:stat_rows], x2[:stat_rows], mean, mul, a, b, out=dx[:stat_rows])
    bn_dx_plain(g2[stat_rows:], x2[stat_rows:], mean, mul, zero, zero, out=dx[stat_rows:])
    return dx.reshape(x.shape), dgamma, dbeta


def bn_stats_plain(x, weight, running_mean, running_var, tracked, eps: float,
                   keep: float):
    return stats_from_sums(*channel_moments_plain(x), _rows(x), weight,
                           running_mean, running_var, tracked, eps, keep)


def bn_apply_plain(x, mean, mul, bias):
    return ((x.float() - mean) * mul + bias).to(x.dtype)


def bn_grad_plain(g, x, mean, rstd, n=None):
    return grad_from_sums(*grad_channel_sums_plain(g, x), n or _rows(x), mean, rstd)


def bn_dx_plain(g, x, mean, mul, a, b, out=None):
    dx = (mul * ((g.float() - a) - (x.float() - mean) * b)).to(x.dtype)
    return dx if out is None else out.copy_(dx)


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


def moment_sums_cuda(x: torch.Tensor) -> torch.Tensor:
    rows, c = _rows_c("moment_sums_cuda", x)
    if rows == 0:  # no launch: zero sums
        return torch.zeros(2, c, dtype=torch.float32, device=x.device)
    buf, po, pw, pt, n = _sums_buffer(rows, c, x, 2, False)
    MOMENTS(x.data_ptr(), po, pw, pt, rows, c, n, _DTYPE_CODE[x.dtype],
            None, None, None, None, 0.0, 0.0, 0.0, _stream(x))
    return buf[:2]


def pair_sums_cuda(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    rows, c = _rows_c("pair_sums_cuda", g, x)
    if rows == 0:
        return torch.zeros(2, c, dtype=torch.float32, device=x.device)
    buf, po, pw, pt, n = _sums_buffer(rows, c, x, 2, True)
    PAIR(g.data_ptr(), x.data_ptr(), po, pw, pt, rows, c, n, _DTYPE_CODE[x.dtype],
         None, None, rows, _stream(x))
    return buf[:2]


def channel_moments_cuda(x: torch.Tensor):
    return moment_sums_cuda(x).unbind(0)


def grad_channel_sums_cuda(g: torch.Tensor, x: torch.Tensor):
    return pair_sums_cuda(g, x).unbind(0)


def _count(name: str, tracked: torch.Tensor, x: torch.Tensor) -> None:
    if tracked.get_device() != x.get_device() or tracked.dtype != torch.int64 \
            or tracked.numel() != 1:
        raise ValueError(f"{name}: the batch count must be one int64 on the input's device")


def _finish_rows(name: str, sums: torch.Tensor, n: int, *ts: torch.Tensor,
                 stat_rows: int = 0):
    """``(rows, C)`` of the fused kernels' ``[..., C]`` inputs ``ts``, after
    the checks of :func:`_rows_c` and of the all-reduced ``sums``: float32
    ``[2, C]``, contiguous, on their device; ``n`` (the statistics' rows
    over all ranks) positive; ``0 <= stat_rows <= rows``."""
    x = ts[-1]
    c = x.shape[-1]
    if sums.dtype != torch.float32 or sums.shape != (2, c) or not sums.is_contiguous():
        raise ValueError(f"{name}: the sums must be contiguous float32 [2, {c}]")
    if n <= 0:
        raise ValueError(f"{name}: statistics over n = {n} rows")
    rows = _rows(x)
    if not 0 <= stat_rows <= rows:
        raise ValueError(f"{name}: stat_rows = {stat_rows} outside [0, {rows}]")
    _rows_c(name, *ts)
    if sums.get_device() != x.get_device():
        raise ValueError(f"{name}: the sums must be on {x.device}")
    return rows, c


def bn_apply_finish_cuda(x, sums, n: int, weight, bias, running_mean, running_var, tracked,
                         eps: float, keep: float):
    name = "bn_apply_finish_cuda"
    rows, c = _finish_rows(name, sums, n, x)
    _channel_vectors(name, c, x, weight, bias, running_mean, running_var)
    _count(name, tracked, x)
    out = torch.empty(6, c, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    APPLY_FINISH(x.data_ptr(), sums.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
                 tracked.data_ptr(), y.data_ptr(), rows, c, n, _DTYPE_CODE[x.dtype], eps, keep,
                 1 - keep, _stream(x))
    return y, out[2:6].unbind(0)


def bn_dx_finish_cuda(g, x, sums, n: int, mean, rstd, mul, stat_rows: int):
    name = "bn_dx_finish_cuda"
    rows, c = _finish_rows(name, sums, n, g, x, stat_rows=stat_rows)
    _channel_vectors(name, c, x, mean, rstd, mul)
    out = torch.empty(5, c, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    DX_FINISH(g.data_ptr(), x.data_ptr(), sums.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
              mul.data_ptr(), out.data_ptr(), dx.data_ptr(), rows, c, n, stat_rows,
              _DTYPE_CODE[x.dtype], _stream(x))
    return dx, out[2], out[0]


def bn_stats_cuda(x, weight, running_mean, running_var, tracked, eps: float,
                  keep: float):
    rows, c = _rows_c("bn_stats_cuda", x)
    _channel_vectors("bn_stats_cuda", c, x, weight, running_mean, running_var)
    _count("bn_stats_cuda", tracked, x)
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


def bn_grad_cuda(g, x, mean, rstd, n=None):
    rows, c = _rows_c("bn_grad_cuda", g, x)
    _channel_vectors("bn_grad_cuda", c, x, mean, rstd)
    buf, po, pw, pt, chunks = _sums_buffer(rows, c, x, 5, True)
    PAIR(g.data_ptr(), x.data_ptr(), po, pw, pt, rows, c, chunks, _DTYPE_CODE[x.dtype],
         mean.data_ptr(), rstd.data_ptr(), n or rows, _stream(x))
    dbeta, _, dgamma, a, b = buf[:5].unbind(0)
    return dgamma, dbeta, a, b


def bn_dx_cuda(g, x, mean, mul, a, b, out=None):
    rows, c = _rows_c("bn_dx_cuda", g, x)
    _channel_vectors("bn_dx_cuda", c, x, mean, mul, a, b)
    if out is None:
        dx = torch.empty_like(x)
    else:
        _rows_c("bn_dx_cuda", out, x)
        dx = out
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


def moment_sums(x: torch.Tensor) -> torch.Tensor:
    """:func:`channel_moments` as one float32 ``[2, C]`` tensor (zeros over
    no rows), to be added up over ranks."""
    if x.device.type == "cpu":
        return moment_sums_plain(x)
    return moment_sums_cuda(x)


def pair_sums(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`grad_channel_sums` as one float32 ``[2, C]`` tensor."""
    if x.device.type == "cpu":
        return pair_sums_plain(g, x)
    return pair_sums_cuda(g, x)


def bn_apply_finish(x, sums, n: int, weight, bias, running_mean, running_var, tracked,
                    eps: float, keep: float):
    """The finishing step of :func:`bn_stats` on the sums of
    :func:`moment_sums` over ``n`` rows (added up over ranks), then
    :func:`bn_apply` of ``x [..., C]`` with its mean and mul: ``(y, (mean,
    var, rstd, mul))``, and the running statistics and count updated in
    place. One launch on the card."""
    if x.device.type == "cpu":
        return bn_apply_finish_plain(x, sums, n, weight, bias, running_mean, running_var,
                                     tracked, eps, keep)
    return bn_apply_finish_cuda(x, sums, n, weight, bias, running_mean, running_var, tracked,
                                eps, keep)


def bn_dx_finish(g, x, sums, n: int, mean, rstd, mul, stat_rows: int):
    """The finishing step of :func:`bn_grad` on the sums of :func:`pair_sums`
    (added up over ranks), for statistics over ``n`` rows, then the input
    gradient: :func:`bn_dx` with its coefficients on the first ``stat_rows``
    rows of ``g, x [..., C]`` and with ``a = b = 0`` on the rest. Returns
    ``(dx, dgamma, dbeta)``. One launch on the card."""
    if x.device.type == "cpu":
        return bn_dx_finish_plain(g, x, sums, n, mean, rstd, mul, stat_rows)
    return bn_dx_finish_cuda(g, x, sums, n, mean, rstd, mul, stat_rows)


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


def bn_grad(g, x, mean, rstd, n=None):
    """``(dgamma, dbeta, a, b)`` float32 [C] of the BN backward for the
    output gradient ``g`` and the input ``x [..., C]``, whose statistics
    came from ``n`` rows (default: all of them)."""
    if x.device.type == "cpu":
        return bn_grad_plain(g, x, mean, rstd, n)
    return bn_grad_cuda(g, x, mean, rstd, n)


def bn_dx(g, x, mean, mul, a, b, out=None):
    """``cast(mul*((g - a) - (x - mean)*b))``, the BN input gradient,
    written into ``out`` (``x``'s shape and type) when given."""
    if x.device.type == "cpu":
        return bn_dx_plain(g, x, mean, mul, a, b, out)
    return bn_dx_cuda(g, x, mean, mul, a, b, out)
