"""Post-training int8 quantisation (PTQ) for serving.

Counterpart of ``s2anet_tpu/ops/quant.py``, same arithmetic:

* activations: per-tensor asymmetric int8 with a zero point, from a range
  calibrated over a few batches (:func:`act_qparams`, :func:`calibrate`);
  the range is widened to include 0, so real 0.0 has an exact code;
* weights: per-output-channel symmetric int8 (:func:`quantize_weights`);
* the conv sums int8 x int8 exactly in int32, removes the zero point's
  share and dequantises: ``y = cast((acc - corr) * (s*sw)) + cast(bias)``
  (:func:`int8_conv`). Two exact forms give the same integers: ``zppad``
  pads the codes with the zero point and subtracts ``zp*sum(wq)`` per
  output channel (the kernel's form, and the JAX package's default);
  ``border`` pads with 0 and subtracts ``zp*M`` with ``M`` the per-position
  sum of the weights over the taps inside the input
  (:func:`border_tap_sums`, plain only).

Public functions keep the JAX layouts: activations NHWC, kernels HWIO.
Each of :func:`quantize_act` and :func:`int8_conv2d` runs its plain version
for a CPU tensor and a kernel of ``csrc/int8_conv.cu`` for a CUDA tensor
(``QUANTIZE``, ``CONV``). The plain versions compute the int32 sums in
float64, where every partial sum is an exact integer
(|acc| <= 9 * 2048 * 127 * 254 < 2^53). The conv kernel's tiles, K split
and persistent grid come from :func:`conv_plan`, a pure function of the
shape and the SM count, kept per shape; the TMA map of each int8 weight is
encoded once (:func:`weight_map`, filled when a conv is frozen to int8).

:class:`QuantMixin` gives a conv module the modes ``none`` (float),
``calib`` (float, and the input's min and max folded into the range slot
the caller names) and ``int8`` (the calibrated ranges and the weights
turned into int8 constants once, by :meth:`QuantMixin.set_mode`).
:class:`QuantConv2d` is a ``Conv2d`` with it; the detector turns the convs
of the chosen scope groups into them in place (``models/conv.py``,
``models/detector.py::S2ANet.set_quant``). The range buffers are not part
of the ``state_dict``, so any float ``state_dict`` loads into a quantised
model.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .._ext import I, P, Kernel, library
from ..parallel import mesh

QMAX = 127.0

# module groups that run their convs through int8 under quant "int8"; the
# default is the JAX package's measured throughput choice
QUANT_SCOPE_ALL = ("backbone", "neck", "head_stacks", "orconv", "heads")
QUANT_SCOPE_DEFAULT = ("backbone", "neck", "head_stacks")
QUANT_MODES = ("none", "calib", "int8")

L = ctypes.c_longlong
QUANTIZE = Kernel("int8_conv", "s2a_quantize_act", [P, P, P, P, L, I, P])
CONV = Kernel("int8_conv", "s2a_int8_conv2d", [P] * 12)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def parse_scope(scope) -> tuple:
    """``scope`` as a tuple of groups; raises on a group not in
    :data:`QUANT_SCOPE_ALL`."""
    if isinstance(scope, str):
        scope = [s.strip() for s in scope.split(",") if s.strip()]
    scope = tuple(scope)
    unknown = set(scope) - set(QUANT_SCOPE_ALL)
    if unknown:
        raise ValueError(f"unknown quant_scope groups {sorted(unknown)}; "
                         f"valid: {QUANT_SCOPE_ALL}")
    return scope


def act_qparams(amin: torch.Tensor, amax: torch.Tensor):
    """Per-tensor ``(scale, zero_point)`` float32 from a calibrated range
    (elementwise over range slots)."""
    lo = torch.clamp_max(amin.float(), 0.0)
    hi = torch.clamp_min(amax.float(), 0.0)
    scale = torch.clamp_min((hi - lo) / (2.0 * QMAX), 1e-8)
    zp = torch.round(-QMAX - lo / scale)  # lo -> -QMAX, hi -> +QMAX
    return scale, zp


def quantize_weights(kernel: torch.Tensor):
    """Per-output-channel symmetric int8 weights of an HWIO kernel:
    ``(wq int8 [kh, kw, cin, cout], sw float32 [cout])``."""
    kf = kernel.float()
    sw = torch.clamp_min(kf.abs().amax(dim=(0, 1, 2)) / QMAX, 1e-12)
    wq = torch.clamp(torch.round(kf / sw), -QMAX, QMAX).to(torch.int8)
    return wq, sw


def border_tap_sums(x_shape, wq: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """Exact ``M[ho, wo, cout]`` (int64): the sum of ``wq`` (HWIO) over the
    taps of each output position that land inside the input (the ``border``
    form's correction)."""
    _, h, w, _ = x_shape
    kh, kw = wq.shape[:2]
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    wsum = wq.long().sum(2)  # [kh, kw, cout]
    ys = torch.arange(ho) * stride - pad
    xs = torch.arange(wo) * stride - pad
    ry = ys[None, :] + torch.arange(kh)[:, None]
    cx = xs[None, :] + torch.arange(kw)[:, None]
    row_ok = ((ry >= 0) & (ry < h)).to(wq.device)  # [kh, ho]
    col_ok = ((cx >= 0) & (cx < w)).to(wq.device)  # [kw, wo]
    t = (col_ok[None, :, :, None] * wsum[:, :, None, :]).sum(1)  # [kh, wo, cout]
    return (row_ok[:, :, None, None] * t[:, None, :, :]).sum(0)  # [ho, wo, cout]


# ---------------------------------------------------------------- plain


def quantize_act_plain(x, scale, zp):
    return torch.clamp(torch.round(x.float() / scale) + zp, -QMAX, QMAX).to(torch.int8)


def int8_sums_plain(xq, wq, zp, stride: int, pad: int, form: str = "zppad"):
    """``acc - corr`` of int8 codes ``xq`` NHWC and ``wq`` HWIO at zero
    point ``zp``: float64 ``[B, Ho, Wo, Cout]`` holding exact integers."""
    x = xq.permute(0, 3, 1, 2).double()
    w = wq.permute(3, 2, 0, 1).double()
    z = float(zp)
    if form == "zppad":
        acc = F.conv2d(F.pad(x, (pad,) * 4, value=z), w, stride=stride)
        out = acc.permute(0, 2, 3, 1) - z * w.sum((1, 2, 3))
    elif form == "border":
        acc = F.conv2d(x, w, stride=stride, padding=pad)
        m = border_tap_sums(xq.shape, wq, stride, pad)
        out = acc.permute(0, 2, 3, 1) - z * m.double()
    else:
        raise ValueError(f"unknown int8 formulation {form!r} (expected zppad | border)")
    return out


def int8_conv2d_plain(xq, wq, mul, corr, zp, stride: int, pad: int, dtype, bias=None):
    """The kernel's function on the kernel's operands: ``xq`` int8 NHWC,
    ``wq`` int8 ``[Cout, kh, kw, Cin]``, ``mul = s*sw`` float32 and ``corr
    = zp*sum(wq)`` int32 ``[Cout]``, the zero point ``zp`` (the padding
    value). Returns ``[B, Ho, Wo, Cout]`` in ``dtype``."""
    x = xq.permute(0, 3, 1, 2).double()
    w = wq.permute(0, 3, 1, 2).double()
    acc = F.conv2d(F.pad(x, (pad,) * 4, value=float(zp)), w, stride=stride)
    y = ((acc.permute(0, 2, 3, 1) - corr.double()).float() * mul).to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


# ---------------------------------------------------------------- CUDA


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _scalar(name: str, t: torch.Tensor, idx: int) -> None:
    # device indices, not torch.device objects: their comparison costs the
    # host several times more, and these wrappers run for every conv
    if t.get_device() != idx or t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"{name}: scale and zero point must be float32 scalars on cuda:{idx}")


def quantize_act_cuda(x, scale, zp):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_act_cuda: unsupported dtype {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("quantize_act_cuda: the input must be contiguous (an NHWC view of "
                         "a channels-last activation) and 16-byte aligned")
    _scalar("quantize_act_cuda", scale, x.get_device())
    _scalar("quantize_act_cuda", zp, x.get_device())
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    QUANTIZE(x.data_ptr(), q.data_ptr(), scale.data_ptr(), zp.data_ptr(), x.numel(),
             _DTYPE_CODE[x.dtype], _stream(x))
    return q


# the conv kernel's tile: BM output pixels; BK bytes of K a stage (or
# ConvPlan.kb)
BM, BK = 128, 128
TICKET_SLOTS = 1024  # split-K tickets a device keeps (one a tile of a split launch)


class ConvPlan(NamedTuple):
    """How ``s2a_int8_conv2d`` covers one conv: tiles of ``BM x bn``
    (``tiles`` of them, ``ntn`` along N); A by TMA as ``[M, Cin]``
    (``amode`` 1: a 1x1 stride-1 conv without padding is a plain product),
    by TMA as one box of ``bw x bh x BM/(bw*bh)`` pixels of ``(Wo, Ho, B)``
    a tap (2: stride 1, ``Cin % 32 == 0``, bf16 output, the boxes tile the
    output), or gathered (0); K's ``nk`` stages of ``kb`` bytes (128; 64 or
    32 for a box mode conv with Cin 64 or 32, a stage in one tap) in
    ``splits`` ranges of ``kper``, walked by ``grid`` persistent blocks."""
    bn: int
    amode: int
    bw: int
    bh: int
    kb: int
    splits: int
    kper: int
    grid: int
    tiles: int
    ntn: int
    nk: int

    @property
    def workspace_ints(self) -> int:
        """int32 partials of a split launch: one ``BM x bn`` tile a unit."""
        return self.tiles * self.splits * BM * self.bn if self.splits > 1 else 0


def conv_plan(b: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int, stride: int,
              pad: int, out_bytes: int, sms: int) -> ConvPlan:
    """The int8 conv kernel's plan for ``[b, h, w, cin] (*) [cout, kh, kw,
    cin]`` with ``out_bytes``-byte outputs on a card of ``sms`` SMs (one
    block an SM fits).

    ``bn`` is 64 for ``cout <= 64``; else 256 where such tiles fill at
    least 3/4 of a wave (bf16 output only: a float32 tile of 256 leaves no
    room for the ring), else 128. A grid under one wave splits K so that
    ``tiles x splits`` fills it (every range non-empty); the grid is at
    most one wave, and blocks walk the ``tiles x splits`` units."""
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    amode, box, kb = int(kh == kw == 1 and stride == 1 and pad == 0), None, BK
    if not amode and stride == 1 and cin % 32 == 0 and out_bytes == 2:
        box = tile_box(b, ho, wo)
        if box:
            amode, kb = 2, stage_bytes(cin)
    mt = -(-(b * ho * wo) // BM)
    nk = -(-(kh * kw * cin) // kb)
    if cout <= 64:
        bn = 64
    elif out_bytes == 2 and cout > 128 and 4 * mt * -(-cout // 256) >= 3 * sms:
        bn = 256
    else:
        bn = 128
    ntn = -(-cout // bn)
    tiles = mt * ntn
    splits, kper = 1, nk
    if tiles < sms and nk > 1:
        kper = -(-nk // min(nk, sms // tiles))
        splits = -(-nk // kper)
    return ConvPlan(bn, amode, *(box or (0, 0)), kb, splits, kper, min(tiles * splits, sms),
                    tiles, ntn, nk)


def stage_bytes(cin: int) -> int:
    """Bytes of K a stage when A comes as one box a tap (``cin % 32 ==
    0``): the largest of 128, 64 and 32 that divides ``cin``, so a stage
    lies in one tap."""
    return next(d for d in (BK, 64, 32) if cin % d == 0)


def tile_box(b: int, ho: int, wo: int):
    """``(bw, bh)`` such that boxes of ``bw x bh x BM/(bw*bh)`` pixels of the
    ``(wo, ho, b)`` output hold ``BM`` consecutive pixels each and tile it
    exactly (row pieces, whole rows, or whole images), else None."""
    if wo % BM == 0:
        return BM, 1
    if BM % wo == 0 and ho % (BM // wo) == 0:
        return wo, BM // wo
    if BM % (wo * ho) == 0 and b % (BM // (wo * ho)) == 0:
        return wo, ho
    return None


_SMS: dict = {}      # device -> SM count
_PLANS: dict = {}    # (device, shapes, stride, pad, dtype) -> (ConvPlan, dims, output shape)
_SPLIT: dict = {}    # device -> (int32 workspace, uint32 tickets left zero by every launch)
_WMAPS: dict = {}    # (wq address, cout, K, kb) -> 128-byte TMA map of wq


def _plan(dev, xshape, wshape, stride: int, pad: int, dtype):
    """``(plan, address of the kernel's dims array, output shape)``, made
    once a shape."""
    key = (dev.index, xshape, wshape, stride, pad, dtype)
    entry = _PLANS.get(key)
    if entry is None:
        if dev.index not in _SMS:
            _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
        b, h, w, cin = xshape
        cout, kh, kw, _ = wshape
        ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
        plan = conv_plan(b, h, w, cin, cout, kh, kw, stride, pad, dtype.itemsize,
                         _SMS[dev.index])
        if plan.splits > 1 and plan.tiles > TICKET_SLOTS:
            raise ValueError(f"int8_conv2d_cuda: {plan.tiles} split tiles > {TICKET_SLOTS}")
        dims = (ctypes.c_int * 20)(b, h, w, cin, cout, kh, kw, stride, pad, ho, wo,
                                   _DTYPE_CODE[dtype], plan.bn, plan.amode, plan.bw, plan.bh,
                                   plan.kb, plan.splits, plan.kper, plan.grid)
        entry = _PLANS[key] = (plan, dims, ctypes.addressof(dims), (b, ho, wo, cout))
    return entry[0], entry[2], entry[3]


def _split_buffers(dev, ints: int):
    """The device's split-K workspace (grown to ``ints`` int32) and tickets.
    Split launches on one device must not run concurrently (on two streams
    at once)."""
    ws, tickets = _SPLIT.get(dev.index, (None, None))
    if tickets is None:
        tickets = torch.zeros(TICKET_SLOTS, dtype=torch.int32, device=dev)
    if ws is None or ws.numel() < ints:
        ws = torch.empty(ints, dtype=torch.int32, device=dev)
    _SPLIT[dev.index] = (ws, tickets)
    return ws.data_ptr(), tickets.data_ptr()


def weight_map(wq: torch.Tensor, kb: int = BK) -> int:
    """Host address of the TMA map of the int8 weights ``wq [Cout, kh, kw,
    Cin]`` on the card for stages of ``kb`` bytes, encoded once: it depends
    on the address and the shape alone, so it stays right for any tensor at
    that address."""
    cout, kh, kw, cin = wq.shape
    k = kh * kw * cin
    key = (wq.data_ptr(), cout, k, kb)
    buf = _WMAPS.get(key)
    if buf is None:
        fn = library("int8_conv").s2a_int8_weight_map
        fn.argtypes = [P, I, I, I, P]
        fn.restype = ctypes.c_int
        buf = ctypes.create_string_buffer(128)
        rc = fn(wq.data_ptr(), cout, k, kb, buf)
        if rc != 0:
            raise RuntimeError(f"s2a_int8_weight_map failed: cudaError {rc}")
        if len(_WMAPS) >= 4096:
            _WMAPS.clear()
        _WMAPS[key] = buf
    return ctypes.addressof(buf)


def int8_conv2d_cuda(xq, wq, mul, corr, zp, stride: int, pad: int, dtype, bias=None):
    cin = xq.shape[-1]
    cout, _, _, wcin = wq.shape
    dev, idx = xq.device, xq.get_device()
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or wcin != cin or xq.dim() != 4:
        raise ValueError("int8_conv2d_cuda: int8 xq [B,H,W,Cin] and wq [Cout,kh,kw,Cin]")
    if cin % 16:
        raise ValueError(f"int8_conv2d_cuda: Cin = {cin} is not a multiple of 16")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"int8_conv2d_cuda: unsupported output dtype {dtype}")
    for t in (xq, wq):
        if t.get_device() != idx or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("int8_conv2d_cuda: xq and wq must be contiguous and 16-byte "
                             "aligned on one device")
    for t, dt in ((mul, torch.float32), (corr, torch.int32)) + (
            ((bias, torch.float32),) if bias is not None else ()):
        if (t.get_device() != idx or t.dtype != dt or t.shape != (cout,)
                or not t.is_contiguous()):
            raise ValueError(f"int8_conv2d_cuda: per-channel vectors must be contiguous "
                             f"[{cout}] on {dev} (mul, bias float32; corr int32)")
    _scalar("int8_conv2d_cuda", zp, idx)
    plan, dims, out_shape = _plan(dev, xq.shape, wq.shape, stride, pad, dtype)
    ws, tickets = _split_buffers(dev, plan.workspace_ints) if plan.splits > 1 else (None, None)
    y = torch.empty(out_shape, dtype=dtype, device=dev)
    CONV(xq.data_ptr(), wq.data_ptr(), mul.data_ptr(), corr.data_ptr(),
         None if bias is None else bias.data_ptr(), zp.data_ptr(), y.data_ptr(),
         weight_map(wq, plan.kb), ws, tickets, dims, _stream(xq))
    return y


# ---------------------------------------------------------------- public


def quantize_act(x, scale, zp):
    """int8 ``clip(round(x / scale) + zp, -127, 127)`` of a float tensor
    (on a CUDA device: contiguous, bfloat16 or float32)."""
    if x.device.type == "cpu":
        return quantize_act_plain(x, scale, zp)
    return quantize_act_cuda(x, scale, zp)


def int8_conv2d(xq, wq, mul, corr, zp, stride: int, pad: int, dtype, bias=None):
    """``cast((conv(pad(xq, zp), wq) - corr) * mul) + cast(bias)``, NHWC,
    from the int8 operands (see :func:`int8_conv2d_plain`)."""
    if xq.device.type == "cpu":
        return int8_conv2d_plain(xq, wq, mul, corr, zp, stride, pad, dtype, bias)
    return int8_conv2d_cuda(xq, wq, mul, corr, zp, stride, pad, dtype, bias)


def int8_conv(x, kernel, amin, amax, stride: int = 1, pad: int = 0, dtype=None, bias=None,
              form: str = "zppad"):
    """Static-PTQ int8 conv of ``x`` NHWC with the float ``kernel`` HWIO
    (symmetric padding ``pad``): quantise ``x`` from its range ``[amin,
    amax]``, quantise the kernel per output channel, sum in int32,
    dequantise to ``dtype`` (default ``x.dtype``), add ``bias`` in
    ``dtype``. ``form="border"`` computes the same integers the other way
    (plain only)."""
    dtype = dtype or x.dtype
    scale, zp = act_qparams(amin, amax)
    xq = quantize_act(x, scale, zp)
    wq, sw = quantize_weights(kernel)
    mul = scale * sw
    if form == "zppad":
        corr = zp.to(torch.int32) * wq.int().sum((0, 1, 2)).int()
        return int8_conv2d(xq, wq.permute(3, 0, 1, 2).contiguous(), mul, corr, zp,
                           stride, pad, dtype, bias)
    y = (int8_sums_plain(xq, wq, zp, stride, pad, form).float() * mul).to(dtype)
    return y if bias is None else y + bias.to(dtype)


# ---------------------------------------------------------------- modules


def fold_batch_range(amin: torch.Tensor, amax: torch.Tensor, x: torch.Tensor,
                     slot: int = 0) -> None:
    """Fold ``x``'s min and max into slot ``slot`` of the range buffers, in
    place on their device."""
    amin[slot:slot + 1] = torch.minimum(amin[slot:slot + 1], x.amin().float().reshape(1))
    amax[slot:slot + 1] = torch.maximum(amax[slot:slot + 1], x.amax().float().reshape(1))


class QuantMixin:
    """int8 PTQ modes for a conv module with ``bias``, ``stride`` and
    ``padding`` (symmetric), a float path :meth:`float_forward` and its
    kernel as HWIO (:meth:`quant_kernel`).

    ``range_slots`` gives a module that is called from several sites with
    shared weights (the head's stacks and heads, one call per FPN level)
    one activation range per site; callers pass the slot. Ranges start at
    +inf / -inf, so the first fold takes the batch's range.
    """

    mode = "none"

    def _init_quant(self, range_slots: int) -> None:
        self.range_slots = range_slots
        self.mode = "none"
        self.register_buffer("act_min", torch.full((range_slots,), math.inf), persistent=False)
        self.register_buffer("act_max", torch.full((range_slots,), -math.inf), persistent=False)
        for name in ("q_wq", "q_scale", "q_zp", "q_mul", "q_corr"):
            self.register_buffer(name, None, persistent=False)
        self._slots = None  # per slot: views of the constants (see quant_forward)

    def set_mode(self, mode: str) -> None:
        """``calib`` resets the ranges; ``int8`` turns the ranges and the
        current weights into int8 constants (raises on a slot that was
        never calibrated); ``none`` runs the float conv."""
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {mode!r} (expected none | calib | int8)")
        self.q_wq = self.q_scale = self.q_zp = self.q_mul = self.q_corr = None
        self._slots = None
        if mode == "calib":  # float32 ranges, whatever a cast made of them
            self.act_min = torch.full_like(self.act_min, math.inf, dtype=torch.float32)
            self.act_max = torch.full_like(self.act_max, -math.inf, dtype=torch.float32)
        elif mode == "int8":
            self._freeze()
        self.mode = mode

    @torch.no_grad()
    def _freeze(self) -> None:
        if not bool(torch.isfinite(self.act_min).all() and torch.isfinite(self.act_max).all()):
            raise ValueError(f"{type(self).__name__} in int8 mode without calibrated "
                             "activation ranges: run ops.quant.calibrate() first")
        wq, sw = quantize_weights(self.quant_kernel().detach())
        scale, zp = act_qparams(self.act_min, self.act_max)
        self.q_wq = wq.permute(3, 0, 1, 2).contiguous()  # [Cout, kh, kw, Cin]
        cin = self.q_wq.shape[-1]
        if self.q_wq.is_cuda and cin % 16 == 0:  # the kernel's TMA maps, encoded once
            for kb in {BK, stage_bytes(cin) if cin % 32 == 0 else BK}:
                weight_map(self.q_wq, kb)
        self.q_scale, self.q_zp = scale, zp
        self.q_mul = scale[:, None] * sw[None]  # [slots, Cout]
        self.q_corr = (zp.to(torch.int32)[:, None]
                       * wq.int().sum((0, 1, 2)).int()[None]).contiguous()

    def quant_forward(self, x: torch.Tensor, slot: int = 0) -> torch.Tensor:
        if self.mode == "none":
            return self.float_forward(x)
        if self.mode == "calib":
            fold_batch_range(self.act_min, self.act_max, x, slot)
            return self.float_forward(x)
        if self._slots is None or self._slots[0] is not self.q_scale:
            # per-slot views, made again only when .to() replaced the buffers
            self._slots = (self.q_scale, [(self.q_scale[i], self.q_zp[i], self.q_mul[i],
                                           self.q_corr[i]) for i in range(self.range_slots)])
        scale, zp, mul, corr = self._slots[1][slot]
        # NHWC view: a no-op on a channels-last activation
        xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        y = int8_conv2d(quantize_act(xh, scale, zp), self.q_wq, mul, corr, zp,
                        self.stride[0], self.padding[0], x.dtype, self.bias)
        return y.permute(0, 3, 1, 2)


class QuantConv2d(nn.Conv2d, QuantMixin):
    """``nn.Conv2d`` that computes in its input's type (as
    ``models/conv.py::Conv2d``) with the int8 PTQ modes of
    :class:`QuantMixin`. Grouped and dilated convs are refused."""

    def __init__(self, *args, range_slots: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        if (self.groups != 1 or any(d != 1 for d in self.dilation)
                or self.padding_mode != "zeros" or isinstance(self.padding, str)
                or len(set(self.padding)) != 1 or len(set(self.stride)) != 1):
            raise NotImplementedError(
                "QuantConv2d (int8 PTQ) supports plain dense convs with square "
                "stride and symmetric padding only; groups / dilation are not "
                "implemented")
        self._init_quant(range_slots)

    def quant_kernel(self) -> torch.Tensor:
        return self.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO

    def float_forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)

    def forward(self, x: torch.Tensor, slot: int = 0) -> torch.Tensor:
        return self.quant_forward(x, slot)


def call_conv(conv: nn.Module, x: torch.Tensor, slot: int) -> torch.Tensor:
    """``conv(x)``, with the range slot when ``conv`` is quantisable."""
    return conv(x, slot) if isinstance(conv, QuantMixin) else conv(x)


def quant_modules(model: nn.Module):
    """``(name, module)`` of every quantisable module under ``model``."""
    return [(n, m) for n, m in model.named_modules() if isinstance(m, QuantMixin)]


@torch.no_grad()
def calibrate(model, batches, scope=QUANT_SCOPE_DEFAULT):
    """Calibrate ``model``'s activation ranges for int8 serving.

    ``model.set_quant("calib", scope)``, then the float forward over each
    prepared batch of ``batches`` (the ranges fold min / max across them,
    the merge of the JAX ``calibrate``). In a data-parallel group each rank
    calibrates on its own batches and the ranges then fold across the
    ranks (min of the minima, max of the maxima: one ``all_reduce`` each),
    so that every rank bakes the same int8 constants. Returns the ranges,
    ``{module name: (act_min, act_max)}``; ``model.set_quant("int8",
    scope)`` then serves with them.
    """
    model.set_quant("calib", scope)
    for x in batches:
        model(x)
    calib = [m for _, m in quant_modules(model) if m.mode == "calib"]
    if mesh.world_size() > 1 and calib:
        for name, fold in (("act_min", mesh.all_reduce_min), ("act_max", mesh.all_reduce_max)):
            bufs = [getattr(m, name) for m in calib]
            flat = fold(torch.cat(bufs))
            torch._foreach_copy_(bufs, list(flat.split([b.numel() for b in bufs])))
    return {n: (m.act_min.clone(), m.act_max.clone())
            for n, m in quant_modules(model) if m.mode == "calib"}


@torch.no_grad()
def load_ranges(model, ranges) -> None:
    """Copy ``{module name: (act_min, act_max)}`` into the range buffers
    of ``model``'s quantisable modules (set to ``calib`` first, so they
    exist); ``model.set_quant("int8", scope)`` then serves with them."""
    for name, (amin, amax) in ranges.items():
        m = model.get_submodule(name)
        m.act_min.copy_(amin)
        m.act_max.copy_(amax)
