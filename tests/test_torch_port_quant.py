"""int8 post-training quantisation of the port (``ops/quant.py``,
``QuantConv2d``, ``S2ANet.set_quant``, ``calibrate``, ``val --quant int8``)
against the JAX package's ``ops/quant.py``, on the CPU at small sizes.

* Codes and parameters (``act_qparams``, ``quantize_weights``, the
  activation codes) equal JAX's bit for bit, in float32 and bfloat16, with
  exact .5 ties and values beyond the clip.
* ``int8_conv`` in both forms: the int32 sums equal JAX's; float32 outputs
  bit-equal; bfloat16 outputs within one bf16 ulp on at most 1% of the
  elements (XLA may round the bias add twice; measured: bit-equal); the
  port's two forms equal each other bit for bit.
* R-18 at 64x64, float32, BatchNorm folded: the port's calibrated ranges
  within 1e-5 (relative) of JAX ``calibrate``'s on the same weights and
  images (the two frameworks' float32 activations differ by up to 2.2e-6
  relative after some 20 convs: measured); one slot a level in the
  stacks, heads and ORConv; with JAX's ranges carried across
  (``models/convert.py``) the port's int8 head outputs against JAX's, in
  units of max(|JAX|, 0.05): odm_cls within 1e-2 (measured 2.5e-4);
  odm_bbox within 0.05 at most and 0.01 on average (measured 0.025 and
  0.0026 at P3). Float activations that differ by 1e-6 move codes across
  rounding boundaries, and the moved codes spread through the quantised
  layers: a 1e-6 relative perturbation of the port's own input moves its
  P3 odm_bbox by about 0.02, as much as the port and JAX differ; the
  quantisation itself moves it by 0.03-0.04. Detections >= 95% matched 1:1
  by (label, score, rotated IoU >= 0.5): the near-tied random-weight
  scores reorder, so NMS keeps a neighbouring anchor here and there.
* ``python -m s2anet_tpu_torch.val --quant int8`` end to end on a stub set,
  its calibration ranges equal to the JAX runner's on the same first batches.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from s2anet_tpu.data.dota import DotaDataset as JaxDataset
from s2anet_tpu.eval import runner as jax_runner
from s2anet_tpu.models.detector import S2ANet as JaxS2ANet
from s2anet_tpu.models.fold import fold_bn_for_eval
from s2anet_tpu.models.head import s2anet_get_bboxes as jax_get_bboxes
from s2anet_tpu.ops import quant as jq
from s2anet_tpu.train.optim import build_optimizer
from s2anet_tpu.train.state import create_train_state
from s2anet_tpu.utils import config as jax_config
from s2anet_tpu_torch import config, predict, val
from s2anet_tpu_torch.eval.runner import evaluate_on_chips
from s2anet_tpu_torch.models.convert import (quant_ranges_from_jax, quant_ranges_to_jax,
                                             save_jax_npz, state_dict_from_jax)
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.models.fold import fold_bn
from s2anet_tpu_torch.models.head import s2anet_get_bboxes
from s2anet_tpu_torch.ops import quant as pq
from s2anet_tpu_torch.ops.iou_rotated import box_iou_rotated_plain
from test_torch_port_data import make_dota_set

FULL = jq.QUANT_SCOPE_ALL
DEFAULT = jq.QUANT_SCOPE_DEFAULT
SCOPES = [DEFAULT, FULL]
SIZE = 64


def _bits(a) -> np.ndarray:
    """The bit patterns of a float32 or bfloat16 array."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


# ---------------------------------------------------------------- codes


@pytest.mark.parametrize("lo,hi", [(-1.3, 2.7), (0.25, 3.0), (-4.0, -0.2), (0.0, 0.0),
                                   (-1e-9, 2e-9), (-0.7, 0.7), (-1.0, 0.984375)])
def test_act_qparams_match_jax(lo, hi):
    s_j, z_j = jq._act_qparams(jnp.float32(lo), jnp.float32(hi))
    s_p, z_p = pq.act_qparams(torch.tensor(lo), torch.tensor(hi))
    assert _bits(np.float32(s_j)) == _bits(s_p.numpy())
    assert _bits(np.float32(z_j)) == _bits(z_p.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 3, 32, 16), (1, 1, 64, 5)])
def test_quantize_weights_match_jax(rng, dtype, shape):
    k = (rng.normal(size=shape) * 0.05).astype(np.float32)
    # channel 0: max 127 * 2^-8, so its scale is exactly 2^-8 and entries at
    # (n + 0.5) * 2^-8 tie; the last channel is all zero (scale 1e-12)
    k[..., 0] = (rng.integers(-126, 126, shape[:3]) + 0.5) * 2.0 ** -8
    k[0, 0, 0, 0] = 127 * 2.0 ** -8
    k[..., -1] = 0.0
    kj = jnp.asarray(k).astype(dtype)
    kp = torch.from_numpy(k).to(getattr(torch, dtype))
    wq_j, sw_j = jq.quantize_weights(kj)
    wq_p, sw_p = pq.quantize_weights(kp)
    np.testing.assert_array_equal(wq_p.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(_bits(sw_p.numpy()), _bits(np.asarray(sw_j)))


def _jax_codes(x, s, zp):
    """The activation codes as the JAX ``int8_conv`` forms them."""
    return jnp.clip(jnp.round(x.astype(jnp.float32) / s) + zp, -jq.QMAX,
                    jq.QMAX).astype(jnp.int8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lo,hi", [(-1.0, 0.984375), (-1.3, 2.7), (0.5, 3.0)])
def test_quantize_act_matches_jax(rng, dtype, lo, hi):
    s, zp = jq._act_qparams(jnp.float32(lo), jnp.float32(hi))
    x = rng.uniform(2.5 * min(lo, 0.0) - 0.5, 2.5 * hi + 0.5, 4000).astype(np.float32)
    # exact ties (n + 0.5) * s where s is a power of two (the first range:
    # s = 2^-7), and values beyond the clip on both sides
    x[:200] = (rng.integers(-150, 150, 200) + 0.5) * np.float32(s)
    x[200:210] = [-1e6, 1e6, -300.0, 300.0, 0.0, -0.0, lo, hi, 2 * lo - 1, 2 * hi + 1]
    xj = jnp.asarray(x).astype(dtype)
    xp = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(_jax_codes(xj, s, zp))
    got = pq.quantize_act(xp, torch.tensor(np.float32(s)), torch.tensor(np.float32(zp)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert {-127, 127} <= set(want.tolist())


# ---------------------------------------------------------------- int8 conv

# kernel, stride, Cin, Cout, bias, sign of the input (0: both signs; +1 /
# -1: one sign, so the zero point is -127 / +127 and every padded tap is far
# from the codes around it)
CONV_CASES = [(1, 1, 32, 5, True, 0), (1, 2, 64, 15, False, 0), (3, 1, 32, 64, True, 1),
              (3, 2, 64, 5, True, 0), (3, 1, 64, 15, False, -1), (3, 2, 32, 64, False, 1)]


def _conv_inputs(case, seed=0):
    k, stride, cin, cout, has_bias, sign = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    if sign:
        x = sign * rng.uniform(2.0, 4.0, x.shape).astype(np.float32)
    kernel = (rng.normal(size=(k, k, cin, cout)) * 0.05).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32) if has_bias else None
    return x, kernel, bias, stride, (k - 1) // 2, float(x.min()), float(x.max())


def _jax_sums(x, kernel, amin, amax, stride, pad, form):
    """``acc - corr`` int32 of the JAX ``int8_conv`` in ``form``."""
    s, zp = jq._act_qparams(jnp.float32(amin), jnp.float32(amax))
    xq = _jax_codes(jnp.asarray(x), s, zp)
    wq, _ = jq.quantize_weights(jnp.asarray(kernel))
    pads = [(pad, pad), (pad, pad)]
    dn = ("NHWC", "HWIO", "NHWC")
    if form == "zppad":
        xp = jax.lax.pad(xq, zp.astype(jnp.int8), ((0, 0, 0), (pad, pad, 0), (pad, pad, 0),
                                                   (0, 0, 0)))
        acc = jax.lax.conv_general_dilated(xp, wq, (stride, stride), "VALID",
                                           dimension_numbers=dn,
                                           preferred_element_type=jnp.int32)
        return acc - zp.astype(jnp.int32) * jnp.sum(wq.astype(jnp.int32), axis=(0, 1, 2))
    acc = jax.lax.conv_general_dilated(xq, wq, (stride, stride), pads, dimension_numbers=dn,
                                       preferred_element_type=jnp.int32)
    m = jq._border_tap_sums(x.shape, wq, (stride, stride), pads)
    return acc - zp.astype(jnp.int32) * m[None]


def _port_conv(x, kernel, bias, stride, pad, amin, amax, dtype, form):
    return pq.int8_conv(torch.from_numpy(x).to(dtype), torch.from_numpy(kernel),
                        torch.tensor(amin), torch.tensor(amax), stride, pad, dtype=dtype,
                        bias=None if bias is None else torch.from_numpy(bias), form=form)


def _jax_conv(x, kernel, bias, stride, pad, amin, amax, dtype, form):
    return jq.int8_conv(jnp.asarray(x).astype(dtype), jnp.asarray(kernel), jnp.float32(amin),
                        jnp.float32(amax), strides=(stride, stride),
                        padding=[(pad, pad), (pad, pad)], dtype=dtype,
                        bias=None if bias is None else jnp.asarray(bias), form=form)


@pytest.mark.parametrize("form", ["zppad", "border"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_int8_sums_match_jax(case, form):
    x, kernel, _, stride, pad, amin, amax = _conv_inputs(case)
    want = np.asarray(_jax_sums(x, kernel, amin, amax, stride, pad, form))
    s, zp = pq.act_qparams(torch.tensor(amin), torch.tensor(amax))
    xq = pq.quantize_act(torch.from_numpy(x), s, zp)
    wq, _ = pq.quantize_weights(torch.from_numpy(kernel))
    got = pq.int8_sums_plain(xq, wq, zp, stride, pad, form)
    assert torch.equal(got, got.round())  # exact integers
    np.testing.assert_array_equal(got.long().numpy(), want.astype(np.int64))


@pytest.mark.parametrize("form", ["zppad", "border"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_int8_conv_float32_bit_equal_jax(case, form):
    x, kernel, bias, stride, pad, amin, amax = _conv_inputs(case, seed=1)
    want = _jax_conv(x, kernel, bias, stride, pad, amin, amax, jnp.float32, form)
    got = _port_conv(x, kernel, bias, stride, pad, amin, amax, torch.float32, form)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(want)))


@pytest.mark.parametrize("case", CONV_CASES)
def test_int8_conv_bfloat16_within_one_ulp_of_jax(case):
    """bfloat16: equal, except at most 1% of the elements by one bf16 ulp
    (XLA may round the bias add twice; on these cases and this XLA: equal
    bit for bit)."""
    x, kernel, bias, stride, pad, amin, amax = _conv_inputs(case, seed=2)
    want = _bits(np.asarray(_jax_conv(x, kernel, bias, stride, pad, amin, amax,
                                      jnp.bfloat16, "zppad"))).astype(np.int32)
    got = _np(_port_conv(x, kernel, bias, stride, pad, amin, amax, torch.bfloat16,
                         "zppad")).astype(np.int32)
    assert got.shape == want.shape
    ulps = np.abs(got - want)  # same sign wherever they differ by one ulp
    assert ulps.max() <= 1 and (ulps > 0).mean() <= 0.01, (ulps.max(), (ulps > 0).mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_CASES)
def test_int8_forms_equal(case, dtype):
    x, kernel, bias, stride, pad, amin, amax = _conv_inputs(case, seed=3)
    a = _port_conv(x, kernel, bias, stride, pad, amin, amax, dtype, "zppad")
    b = _port_conv(x, kernel, bias, stride, pad, amin, amax, dtype, "border")
    assert a.dtype == b.dtype == dtype and torch.equal(a, b)


# ---------------------------------------------------------------- R-18


@pytest.fixture(scope="module")
def r18():
    """JAX and port R-18 on the same folded weights, two calibration
    batches, and per scope: JAX's ranges and int8 outputs, the port's own
    ranges, and the port's int8 outputs on JAX's ranges."""
    rng = np.random.default_rng(11)
    jmodel = JaxS2ANet(backbone_name="resnet18", num_classes=15, deform_impl="gather")
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.2, a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.8, 1.2, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    fmodel, fvars = fold_bn_for_eval(jmodel, variables)
    port = S2ANet("resnet18", num_classes=15)
    port.load_state_dict(state_dict_from_jax(variables, "resnet18"))
    port.eval()
    fold_bn(port)
    batches = [rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    tb = [torch.from_numpy(b).permute(0, 3, 1, 2) for b in batches]
    out = {"port": port, "batches": batches, "jax_vars": fvars}
    for scope in SCOPES:
        mdl = fmodel.clone(quant_scope=scope)
        q = jax.device_get(jq.calibrate(mdl, fvars, jnp.stack(batches)))
        qmodel = mdl.clone(quant="int8")
        want = jax.device_get(jax.jit(lambda v, x: qmodel.apply(v, x))(
            {**fvars, "quant": q}, jnp.asarray(batches[0])))
        own = {k: tuple(t.clone() for t in v) for k, v in pq.calibrate(port, tb, scope).items()}
        names = [n for n, m in pq.quant_modules(port) if m.mode == "calib"]
        pq.load_ranges(port, quant_ranges_from_jax(q, names))
        port.set_quant("int8", scope)
        with torch.no_grad():
            got = port(tb[0])
        own_out = None
        if scope == FULL:  # the port's own pipeline: its ranges, then int8
            pq.load_ranges(port, own)
            port.set_quant("int8", scope)
            with torch.no_grad():
                own_out = port(tb[0])
            port.set_quant("none", scope)
            with torch.no_grad():
                out["float"] = port(tb[0])
        out[scope] = dict(jax_ranges=q, port_ranges=own, names=names, want=want, got=got,
                          own_out=own_out)
    port.set_quant("none")
    return out


@pytest.mark.parametrize("scope", SCOPES, ids=["default", "full"])
def test_calibrate_ranges_match_jax(r18, scope):
    res = r18[scope]
    want = quant_ranges_from_jax(res["jax_ranges"], res["names"])
    n_jax = len(flatten_dict(res["jax_ranges"])) // 2
    assert len(want) == len(res["port_ranges"]) == n_jax
    for name, (lo, hi) in res["port_ranges"].items():
        for got, exp in zip((lo, hi), want[name]):
            assert torch.isfinite(got).all(), name
            torch.testing.assert_close(got, exp, rtol=1e-5, atol=0, msg=name)


def test_range_slots_per_level(r18):
    res = r18[FULL]
    per_level = {n: r for n, r in res["port_ranges"].items() if n.startswith("head.")}
    assert "head.or_conv" in per_level and len(per_level) == 8 + 4 + 1
    assert all(lo.shape == hi.shape == (5,) for lo, hi in per_level.values())
    assert any(len(torch.unique(hi)) > 1 for _, hi in per_level.values())
    assert all(lo.shape == (1,) for n, (lo, _) in res["port_ranges"].items()
               if not n.startswith("head."))


def _scale_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    return float(np.abs(a - np.asarray(b, np.float32)).max() / max(np.abs(a).max(), 0.05))


def _assert_int8_close(got, want, what):
    """odm_cls within 1e-2 of scale; odm_bbox within 0.05 at most and 0.01
    on average (see the module docstring)."""
    for key in ("odm_cls", "odm_bbox"):
        for lvl, (g, w) in enumerate(zip(got[key], want[key])):
            assert g.dtype == torch.float32
            w = np.asarray(w, np.float32)
            err = np.abs(g.numpy() - w) / max(np.abs(w).max(), 0.05)
            if key == "odm_cls":
                assert err.max() <= 1e-2, (what, key, lvl, err.max())
            else:
                assert err.max() <= 0.05 and err.mean() <= 0.01, (what, key, lvl, err.max(),
                                                                  err.mean())


@pytest.mark.parametrize("scope", SCOPES, ids=["default", "full"])
def test_int8_forward_matches_jax(r18, scope):
    res = r18[scope]
    _assert_int8_close(res["got"], res["want"], scope)


def _match_1to1(a, la, b, lb):
    """Detections of ``a`` matched 1:1 to ``b`` by label, score within
    1e-3 and rotated IoU >= 0.5."""
    iou = box_iou_rotated_plain(torch.from_numpy(a[:, :5]), torch.from_numpy(b[:, :5])).numpy()
    used = np.zeros(len(b), bool)
    n = 0
    for i in range(len(a)):
        cand = np.nonzero((~used) & (lb == la[i]) & (np.abs(b[:, 5] - a[i, 5]) < 1e-3)
                          & (iou[i] >= 0.5))[0]
        if len(cand):
            used[cand[np.argmax(iou[i, cand])]] = True
            n += 1
    return n


@pytest.mark.parametrize("scope", SCOPES, ids=["default", "full"])
def test_int8_detections_match_jax(r18, scope):
    res = r18[scope]
    scores = np.concatenate([np.asarray(c).reshape(2, -1) for c in res["want"]["odm_cls"]], 1)
    thr = float(1 / (1 + np.exp(-np.sort(scores[0])[-300])))
    kw = dict(score_thr=thr, iou_thr=0.5, max_per_img=500, pre_nms_cap=1024)
    det_g, lab_g, val_g = (t.numpy() for t in s2anet_get_bboxes(res["got"], **kw))
    det_w, lab_w, val_w = (np.asarray(t) for t in jax_get_bboxes(
        jax.tree_util.tree_map(jnp.asarray, res["want"]), **kw))
    for i in range(2):
        a, la = det_g[i][val_g[i]], lab_g[i][val_g[i]]
        b, lb = det_w[i][val_w[i]], lab_w[i][val_w[i]]
        assert len(b) > 50
        assert _match_1to1(a, la, b, lb) >= 0.95 * max(len(a), len(b))


def test_fold_then_calibrate_then_int8(r18):
    """The serving pipeline (``test_fold_composes_with_int8`` of the JAX
    package): fold, calibrate, int8 -- the port's own ranges -- against
    JAX's, and within the JAX bar of 0.07 (of scale) of the float model;
    folding a model that holds int8 constants is refused."""
    res = r18[FULL]
    _assert_int8_close(res["own_out"], res["want"], "own ranges")
    for key in ("odm_cls", "odm_bbox"):
        for lvl, (g, f) in enumerate(zip(res["own_out"][key], r18["float"][key])):
            assert _scale_err(f.numpy(), g.numpy()) < 0.07, (key, lvl)
    port = S2ANet("resnet18", num_classes=3).init_weights(torch.Generator().manual_seed(0))
    port.eval()
    pq.calibrate(port, [torch.rand(1, 3, SIZE, SIZE)])
    port.set_quant("int8")
    with pytest.raises(ValueError, match="fold BatchNorm before"):
        fold_bn(port)


def test_quant_ranges_round_trip(r18):
    """JAX ranges -> port buffers -> JAX ranges, equal."""
    res = r18[FULL]
    port = r18["port"]
    port.set_quant("calib", FULL)
    pq.load_ranges(port, quant_ranges_from_jax(res["jax_ranges"], res["names"]))
    back = quant_ranges_to_jax({n: (m.act_min, m.act_max) for n, m in pq.quant_modules(port)
                                if m.mode == "calib"})
    port.set_quant("none")
    flat_a, flat_b = flatten_dict(res["jax_ranges"]), flatten_dict(back)
    assert set(flat_a) == set(flat_b)
    for k, v in flat_a.items():
        np.testing.assert_array_equal(flat_b[k], np.asarray(v), err_msg=str(k))


@pytest.mark.parametrize("scope", SCOPES, ids=["default", "full"])
def test_int8_output_types_match_jax(r18, scope):
    """In a bfloat16 run a quantised prediction head returns bfloat16, as
    the JAX ``QuantConv`` does (a float one returns float32)."""
    jm = JaxS2ANet(backbone_name="resnet18", num_classes=15, deform_impl="gather",
                   quant="int8", quant_scope=scope)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.bfloat16)
    shapes = jax.eval_shape(lambda v: jm.apply(v, x), jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x)))
    port = S2ANet("resnet18", num_classes=15).init_weights(torch.Generator().manual_seed(0))
    port.eval()
    fold_bn(port)
    port.set_quant("calib", scope)
    port.cast(torch.bfloat16)
    pq.calibrate(port, [torch.rand(1, 3, SIZE, SIZE).bfloat16()], scope)
    port.set_quant("int8", scope)
    with torch.no_grad():
        out = port(torch.rand(1, 3, SIZE, SIZE).bfloat16())
    for key in ("fam_cls", "fam_bbox", "odm_cls", "odm_bbox"):
        want = str(shapes[key][0].dtype)
        assert str(out[key][0].dtype) == f"torch.{want}", (key, want)


def test_int8_resnet50_moves_outputs_as_jax():
    """R-50 at 128x128 (Bottleneck blocks, 52 quantised backbone convs),
    default scope, float32, folded random weights with non-trivial
    BatchNorm statistics, two images: over the levels, the port's int8
    outputs move from its float outputs by no more than twice what the JAX
    package's int8 outputs move from its float ones (in units of
    max(|float|, 0.05); each side calibrates its own ranges).
    Deep int8 paths are chaotic on random weights (port and JAX int8 differ
    by as much as int8 and float do), so this holds the quantisation noise,
    not the bits; prints both (``-s``)."""
    size = 128
    rng = np.random.default_rng(11)
    jmodel = JaxS2ANet(backbone_name="resnet50", num_classes=15, deform_impl="gather")
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32)))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.2, a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.8, 1.2, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    fmodel, fvars = fold_bn_for_eval(jmodel, variables)
    imgs = rng.uniform(size=(2, size, size, 3)).astype(np.float32)
    q = jq.calibrate(fmodel, fvars, jnp.asarray(imgs)[None])
    want_f = jax.device_get(jax.jit(lambda v, x: fmodel.apply(v, x))(fvars, jnp.asarray(imgs)))
    qmodel = fmodel.clone(quant="int8")
    want_q = jax.device_get(jax.jit(lambda v, x: qmodel.apply(v, x))(
        {**fvars, "quant": q}, jnp.asarray(imgs)))
    port = S2ANet("resnet50", num_classes=15)
    port.load_state_dict(state_dict_from_jax(variables, "resnet50"))
    port.eval()
    fold_bn(port)
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_f = port(x)
        pq.calibrate(port, [x])
        port.set_quant("int8")
        got_q = port(x)
    for key in ("odm_cls", "odm_bbox"):
        jax_moves = [_scale_err(f, q_) for f, q_ in zip(want_f[key], want_q[key])]
        port_moves = [_scale_err(f.numpy(), q_.numpy()) for f, q_ in zip(got_f[key], got_q[key])]
        print(f"R-50 {size}^2 {key}: int8 against float, JAX "
              f"{[round(v, 4) for v in jax_moves]}, port {[round(v, 4) for v in port_moves]}")
        assert max(port_moves) <= 2 * max(jax_moves), key


# ---------------------------------------------------------------- errors


@pytest.mark.parametrize("where", ["parse_scope", "set_quant", "runner", "val", "predictor"])
def test_unknown_scope_raises(where, tmp_path):
    bad = ("backbone", "typo")
    with pytest.raises(ValueError, match="typo"):
        if where == "parse_scope":
            pq.parse_scope("backbone,typo")
        elif where == "set_quant":
            S2ANet("resnet18", num_classes=3).set_quant("calib", bad)
        elif where == "runner":  # before the dataset is read: there is none
            cfg = config.load_config(None, {"model": {"quant": "int8", "quant_scope": bad}})
            evaluate_on_chips(None, cfg)
        elif where == "val":
            val.main(["--device", "cpu", "--data-root", str(tmp_path / "none"),
                      "--quant", "int8", "--quant-scope", "backbone,typo"])
        else:
            predict.S2ANetPredictor(config.ModelConfig(backbone="resnet18", quant="int8",
                                                       quant_scope=bad), device="cpu")


@pytest.mark.parametrize("where", ["module", "predictor"])
def test_int8_without_ranges_raises(where):
    if where == "module":
        conv = pq.QuantConv2d(8, 4, 3, 1, 1, range_slots=2)
        with pytest.raises(ValueError, match="calibrate"):
            conv.set_mode("int8")
        conv.set_mode("calib")
        conv(torch.rand(1, 8, 5, 5), 0)  # slot 1 never sees an input
        with pytest.raises(ValueError, match="calibrate"):
            conv.set_mode("int8")
    else:
        p = predict.S2ANetPredictor(config.ModelConfig(backbone="resnet18", quant="int8"),
                                    device="cpu", dtype=torch.float32)
        with pytest.raises(RuntimeError, match="calibrate"):
            p.predict(np.zeros((1, SIZE, SIZE, 3), np.uint8))


@pytest.mark.parametrize("kwargs", [{"groups": 2}, {"dilation": 2}],
                         ids=["grouped", "dilated"])
def test_grouped_or_dilated_conv_raises(kwargs):
    with pytest.raises(NotImplementedError, match="groups / dilation"):
        pq.QuantConv2d(8, 8, 3, 1, 1, **kwargs)


# ---------------------------------------------------------------- val


def test_val_quant_int8_calibrates_as_jax(tmp_path):
    """``val --quant int8`` on 5 chips at batch 2: the runner calibrates on
    its first 4 batches, of which there are 3 (the last has 1 chip,
    wrap-padded), then evaluates int8; the ranges equal those the JAX
    runner calibrates on the same batches (captured from its
    ``calibrate``, which ends the JAX run there)."""
    size = 96
    make_dota_set(tmp_path / "set", np.random.default_rng(5), [(size, size)] * 5, n_obj=3)
    images = tmp_path / "set" / "images"
    jmodel = JaxS2ANet(backbone_name="resnet18", num_classes=15, deform_impl="gather")
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, size, size, 3), jnp.float32)))
    save_jax_npz(tmp_path / "w.npz", variables)

    got = val.main(["--device", "cpu", "--dtype", "float32", "--backbone", "resnet18",
                    "--img-size", str(size), "--batch-size", "2", "--quant", "int8",
                    "--quant-scope", ",".join(FULL), "--weights", str(tmp_path / "w.npz"),
                    "--data-root", str(images)])
    assert 0.0 <= got["map50"] <= 1.0 and got["n_images"] == 5

    captured = {}
    real = jq.calibrate

    class Stop(Exception):
        pass

    def capture(*args, **kwargs):
        captured["q"] = jax.device_get(real(*args, **kwargs))
        captured["k"] = np.shape(args[2])[0]
        raise Stop

    jcfg = jax_config.load_config(None, {
        "model": {"backbone": "resnet18", "quant": "int8", "quant_scope": list(FULL)},
        "data": {"img_size": size}, "eval": {"batch_size": 2},
        "train": {"dtype": "float32"}})
    tx = build_optimizer(lambda _: 0.0, params_example=variables["params"])
    state = create_train_state(variables["params"], variables["batch_stats"], tx)
    with mock.patch.object(jq, "calibrate", capture), pytest.raises(Stop):
        jax_runner.evaluate_on_chips(jmodel, state, jcfg,
                                     dataset=JaxDataset(images, img_size=size,
                                                                cache_images="disk"))
    assert captured["k"] == 3
    want = quant_ranges_from_jax(captured["q"], got["quant_ranges"])
    assert set(want) == set(got["quant_ranges"])
    for name, (lo, hi) in got["quant_ranges"].items():
        for g, w in zip((lo, hi), want[name]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0, msg=name)
