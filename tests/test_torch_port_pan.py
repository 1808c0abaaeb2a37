"""The port's PAN neck (``s2anet_tpu_torch/models/fpn.py::PAN``) against
the JAX package's ``s2anet_tpu/models/fpn.py::PAN``, on the CPU at small
widths: in_channels (32, 64, 128), 32 out, 5 outputs, C3-C5 of 32^2, 16^2
and 8^2, batch 2, made from a numpy seed. The JAX parameters (with random
biases in place of the zero initial ones, so that the biases are carried
too) go to the port through ``models/convert.py``.

* float32: every level within 1e-5 of the JAX level's largest magnitude;
* bfloat16 (the port's inputs and compute in bf16) against the JAX float32
  output: within 2e-2 of the level's largest magnitude (bf16 keeps 8 bits:
  one rounding is 2^-9 relative; a level passes through up to 7 convs of
  at most 288 terms; measured 2.7e-3 to 6.5e-3 over four seeds);
* the order of updates: two plausible misorderings of the bottom-up loop
  (each level reading the FPN's output of the level below instead of its
  update, and P6/P7 taking a bottom-up term too) are far outside the
  float32 bound, so the parity case fails on either;
* int8: JAX ``PAN(quant="calib")``'s ranges over two batches carried to the
  port (and back: the round trip gives the JAX tree), the port's own
  calibration within 1e-5 (relative) of them, and the port's int8 PAN
  bit-equal to JAX ``PAN(quant="int8")`` in float32;
* ``quant_sites``: the 3 laterals, the 5 output convs, the 2 bottom-up and
  4 PAN output convs (14), the detector's ``neck`` scope taking all of
  them when its neck is a PAN; at R-50 1024^2 batch 8 each of the 14 gets
  an int8 kernel plan that the kernel's argument checks accept.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from s2anet_tpu.models.fpn import PAN as JaxPAN
from s2anet_tpu_torch.models.convert import (neck_state_dict_from_jax, quant_ranges_from_jax,
                                             quant_ranges_to_jax)
from s2anet_tpu_torch.models.conv import quantizable
from s2anet_tpu_torch.models.detector import S2ANet
from s2anet_tpu_torch.models.fpn import PAN
from s2anet_tpu_torch.ops import quant as pq
from s2anet_tpu_torch.ops.quant import QuantConv2d

IN_CH, OUT, NUM_OUTS, BATCH = (32, 64, 128), 32, 5, 2
SIDES = (32, 16, 8)
F32_TOL, BF16_TOL = 1e-5, 2e-2


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (BATCH, s, s, c)).astype(np.float32)
            for s, c in zip(SIDES, IN_CH)]


def _nchw(xs, dtype=torch.float32):
    return [torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype) for x in xs]


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    """JAX PAN parameters (random biases) and the port PAN carrying them."""
    jmodel = JaxPAN(IN_CH, OUT, NUM_OUTS)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        [jnp.asarray(x) for x in _inputs(0)]))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.1, a.shape).astype(np.float32)
                         if path[-1].key == "bias" else np.asarray(a)), params)
    port = PAN(IN_CH, OUT, NUM_OUTS)
    port.load_state_dict(neck_state_dict_from_jax(params))  # strict: every key
    return jmodel, params, port.eval()


def _jax_out(jmodel, variables, xs):
    return [np.asarray(o) for o in jmodel.apply(variables, [jnp.asarray(x) for x in xs])]


def test_pan_float32_matches_jax(pair):
    jmodel, params, port = pair
    xs = _inputs(2)
    want = _jax_out(jmodel, {"params": params}, xs)
    with torch.no_grad():
        got = [_nhwc(o) for o in port(_nchw(xs))]
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (BATCH, s, s, OUT) for s in (32, 16, 8, 4, 2)]
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= F32_TOL, (lvl, _rel(g, w))
    assert all((w >= 0).all() for w in want[1:])  # ReLU after each PAN output conv


def test_pan_bfloat16_within_bound_of_jax_float32(pair):
    jmodel, params, port = pair
    xs = _inputs(3)
    want = _jax_out(jmodel, {"params": params}, xs)
    with torch.no_grad():
        got = [_nhwc(o) for o in port(_nchw(xs, torch.bfloat16))]
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= BF16_TOL, errs


def _misordered(port, xs, stale_below: bool, extra_bottom_up: bool):
    """The port PAN's convs in a wrong order: each level's bottom-up input
    the FPN's output below it (not its update), or P6/P7 given a bottom-up
    term through the last down conv."""
    with torch.no_grad():
        fpn = list(port.fpn(xs))
        outs = list(fpn)
        n_in = port.n_in
        for i in range(1, n_in):
            below = fpn[i - 1] if stale_below else outs[i - 1]
            outs[i] = F.relu(port.pan_out_convs[i - 1](
                outs[i] + F.relu(port.pan_down_convs[i - 1](below))))
        for i in range(n_in, len(outs)):
            up = F.relu(port.pan_down_convs[-1](outs[i - 1])) if extra_bottom_up else 0
            outs[i] = F.relu(port.pan_out_convs[i - 1](outs[i] + up))
    return [_nhwc(o) for o in outs]


@pytest.mark.parametrize("stale_below, extra_bottom_up, levels",
                         [(True, False, (2,)), (False, True, (3, 4))],
                         ids=["stale-level-below", "bottom-up-into-p6-p7"])
def test_pan_update_order_is_checked(pair, stale_below, extra_bottom_up, levels):
    jmodel, params, port = pair
    xs = _inputs(4)
    want = _jax_out(jmodel, {"params": params}, xs)
    right = _misordered(port, _nchw(xs), False, False)
    wrong = _misordered(port, _nchw(xs), stale_below, extra_bottom_up)
    assert max(_rel(g, w) for g, w in zip(right, want)) <= F32_TOL
    for lvl in levels:
        assert _rel(wrong[lvl], want[lvl]) > 1000 * F32_TOL, (lvl, _rel(wrong[lvl], want[lvl]))


def _quantised(port):
    """The port PAN's convs as ``QuantConv2d`` in place, by name."""
    for parent, key in port.quant_sites():
        quantizable(parent, key)
    return {n: m for n, m in port.named_modules() if isinstance(m, QuantConv2d)}


def test_pan_int8_bit_equal_jax(pair):
    jmodel, params, port = pair
    batches = [_inputs(5), _inputs(6)]
    # JAX calibration: the ranges folded over the two batches
    calib = jmodel.clone(quant="calib")
    variables = {"params": params}
    for xs in batches:
        _, upd = calib.apply(variables, [jnp.asarray(x) for x in xs], mutable=["quant"])
        variables = {"params": params, "quant": upd["quant"]}
    q = jax.device_get(variables["quant"])

    convs = _quantised(port)
    assert len(convs) == 14
    for m in convs.values():
        m.set_mode("calib")
    with torch.no_grad():
        for xs in batches:
            port(_nchw(xs))
    ranges = quant_ranges_from_jax(q, convs)
    assert set(ranges) == set(convs)
    for name, (amin, amax) in ranges.items():
        for own, theirs in ((convs[name].act_min, amin), (convs[name].act_max, amax)):
            assert torch.allclose(own, theirs, rtol=1e-5, atol=1e-6), name
    back = quant_ranges_to_jax(ranges)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(q)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(q)):
        np.testing.assert_array_equal(a, np.asarray(b))

    pq.load_ranges(port, ranges)
    for m in convs.values():
        m.set_mode("int8")
    xs = _inputs(7)
    want = _jax_out(jmodel.clone(quant="int8"), {"params": params, "quant": q}, xs)
    with torch.no_grad():
        got = [_nhwc(o) for o in port(_nchw(xs))]
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32), err_msg=str(lvl))
    for m in convs.values():
        m.set_mode("none")


def test_pan_quant_sites_and_detector_neck_scope():
    port = PAN(IN_CH, OUT, NUM_OUTS)
    n_in = len(IN_CH)
    sites = list(port.quant_sites())
    assert len(sites) == n_in + NUM_OUTS + (n_in - 1) + (NUM_OUTS - 1) == 14
    assert len({id(p._modules[k]) for p, k in sites}) == 14
    assert {id(m) for m in port.modules() if isinstance(m, torch.nn.Conv2d)} == {
        id(p._modules[k]) for p, k in sites}

    det = S2ANet("resnet18", num_classes=2)
    det.neck = PAN((128, 256, 512), 256, 5)
    det.set_quant("calib", ("neck",))
    names = [n for n, m in det.named_modules() if isinstance(m, QuantConv2d)]
    assert len(names) == 14 and all(n.startswith("neck.") for n in names)
    assert all(det.get_submodule(n).mode == "calib" for n in names)
    # and their JAX "quant" paths, inside the detector's neck
    tree = quant_ranges_to_jax({n: (torch.zeros(1), torch.ones(1)) for n in names})
    assert set(tree) == {"neck"} and set(tree["neck"]) == {
        "fpn", "pan_down_0", "pan_down_1", "pan_out_0", "pan_out_1", "pan_out_2", "pan_out_3"}
    assert len(tree["neck"]["fpn"]) == 8


def test_pan_init_weights():
    """Xavier-uniform in the inner FPN; the PAN convs ``lecun_normal``
    (truncated at two standard deviations of std sqrt(1 / fan_in) /
    0.8796...), zero biases; seeded by the generator."""
    a, b = PAN(IN_CH, OUT, NUM_OUTS), PAN(IN_CH, OUT, NUM_OUTS)
    a.init_weights(torch.Generator().manual_seed(0))
    b.init_weights(torch.Generator().manual_seed(0))
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka
    w = torch.cat([c.weight.detach().flatten() for c in (*a.pan_down_convs, *a.pan_out_convs)])
    std = (1.0 / (OUT * 9)) ** 0.5
    assert w.abs().max() <= 2 * std / 0.87962566103423978
    assert abs(float(w.std()) / std - 1) < 0.05
    assert all(not c.bias.any() for c in (*a.pan_down_convs, *a.pan_out_convs))
    fpn_w = a.fpn.fpn_convs[0].weight
    limit = (6.0 / (OUT * 9 + OUT * 9)) ** 0.5
    assert fpn_w.abs().max() <= limit and fpn_w.abs().max() > 0.9 * limit


def test_pan_int8_plans_at_r50_serving():
    """The int8 kernel's plan for each of the 14 quantised convs of a PAN
    neck in R-50 1024^2 batch-8 bf16 serving (shapes from a forward on the
    meta device, the AlignConv stubbed), on cards of 132, 114 and 78 SMs:
    a plan the kernel's argument checks in ``csrc/int8_conv.cu`` accept,
    whose units cover every tile and K stage once; the bottom-up convs
    (stride 2) gather A, the PAN output convs read it as boxes, the
    laterals as a plain product."""
    from unittest import mock

    from s2anet_tpu_torch.models import head as head_mod
    from s2anet_tpu_torch.models.resnet import stage_channels

    net = S2ANet("resnet50", 15)
    net.neck = PAN(stage_channels("resnet50"), 256, 5)
    net = net.to("meta").eval()
    calls = []

    def record(self, x, slot=0):
        if self.mode != "none":
            kh, _, cin, cout = self.quant_kernel().shape
            b, _, h, w = x.shape
            calls.append((b, h, w, cin, cout, kh, self.stride[0], self.padding[0]))
        return self.float_forward(x)

    def deform(x, offsets, w):
        return torch.empty(x.shape[:-1] + (w.shape[-1],), dtype=x.dtype, device=x.device)

    net.set_quant("calib", ("neck",)).cast(torch.bfloat16)
    with mock.patch.object(pq.QuantMixin, "quant_forward", record), \
            mock.patch.object(head_mod, "deform_conv2d", deform), torch.no_grad():
        net(torch.empty(8, 3, 1024, 1024, device="meta", dtype=torch.bfloat16))
    assert len(calls) == 14
    assert sorted(c for c in calls if c[6] == 2 and c[3] == 256 and c[2] in (128, 64)) == [
        (8, 64, 64, 256, 256, 3, 2, 1), (8, 128, 128, 256, 256, 3, 2, 1)]
    for sms in (132, 114, 78):
        for b, h, w, cin, cout, k, stride, pad in calls:
            plan = pq.conv_plan(b, h, w, cin, cout, k, k, stride, pad, 2, sms)
            ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
            m = b * ho * wo
            assert plan.bn in (64, 128, 256) and cin % 16 == 0
            assert plan.tiles == -(-m // pq.BM) * plan.ntn and plan.ntn * plan.bn >= cout
            assert plan.nk == -(-(k * k * cin) // plan.kb)
            assert 1 <= plan.grid <= sms and plan.splits * plan.kper >= plan.nk
            assert (plan.splits - 1) * plan.kper < plan.nk  # every range non-empty
            if plan.splits > 1:
                assert plan.tiles <= pq.TICKET_SLOTS
            if stride == 2:
                assert plan.amode == 0 and plan.kb == 128
            elif k == 1:
                assert plan.amode == 1 and plan.kb == 128
            else:  # the kernel's checks of a box mode conv
                assert plan.amode == 2 and cin % plan.kb == 0
                bb = pq.BM // (plan.bw * plan.bh)
                assert bb >= 1 and plan.bw * plan.bh * bb == pq.BM
                assert wo % plan.bw == 0 and ho % plan.bh == 0 and b % bb == 0
                assert (plan.bw == wo or plan.bh * bb == 1) and (plan.bh == ho or bb == 1)
