"""Sampled BatchNorm statistics (``bn_stats_images``) and the inference-mode
BatchNorm of frozen stages and ``norm_eval`` against the JAX package, on
the CPU (the plain versions of the BN kernels).

* ``BatchNorm2d(stats_images=k)`` in train mode against the JAX
  ``SampledBatchNorm``: in float32 the output, the vjp (dx, dgamma, dbeta)
  within 1e-5 of the largest value (as tests/test_pallas_bn.py holds
  the Pallas BN), running statistics within 1e-6.
* In bfloat16 the JAX function rounds mean, mul and bias to bfloat16 and
  normalises in bfloat16 arithmetic; the port normalises in float32 and
  rounds once, as its full-batch layer. So the port is held to the JAX
  function evaluated in float32 on the same bfloat16 inputs (output and dx
  within one bfloat16 ulp of each element, plus 1e-6 of the largest value
  for float32 rounding where terms cancel; dgamma and dbeta within 1e-5),
  and to the JAX bfloat16 function within the measured gap: output within
  2 ulps of the largest output (measured: 1 ulp), dx within 2^-5 of the
  largest dx (measured: up to 0.012). JAX's bfloat16 dgamma and dbeta
  (reduced in bfloat16; measured 2-11% from the float32 values) are
  further from the float32 values than the port's.
* The eval path (frozen stages, ``norm_eval``) against flax's
  ``BatchNorm(use_running_average=True)`` with the model's dtype: float32
  within 1e-6 of the largest value, bfloat16 within one ulp of each element
  (equal but for rare one-ulp flips); gamma and beta gradients within 1e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.models.resnet import SampledBatchNorm
from s2anet_tpu_torch.models.bn import BatchNorm2d

CASES = [((4, 8, 8, 64), 2), ((3, 5, 7, 24), 1), ((8, 16, 16, 128), 2), ((2, 4, 4, 32), 5)]


def _variables(c, rng):
    return {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.normal(0, 0.3, c).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.2, c).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, c).astype(np.float32)},
    }


def _port_bn(v, k=0, train=True):
    bn = BatchNorm2d(v["params"]["scale"].shape[0], stats_images=k)
    bn.load_state_dict({
        "weight": torch.from_numpy(v["params"]["scale"]),
        "bias": torch.from_numpy(v["params"]["bias"]),
        "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(v["batch_stats"]["var"]),
        "num_batches_tracked": torch.tensor(0)})
    return bn.train(train)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return _variables(shape[-1], rng), x, g


def _jax_vjp(mod, v, x, g):
    """``(y, running statistics, (dparams, dx))`` of ``mod`` at ``x`` for
    the output cotangent ``g``."""
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])

    def f(p, xx):
        return mod.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                         mutable=["batch_stats"])

    (y, upd), pull = jax.vjp(f, params, x)
    zero = jax.tree_util.tree_map(jnp.zeros_like, upd)
    return y, upd["batch_stats"], pull((g, zero))


def _port_vjp(bn, x, g):
    """``(y, (dweight, dbias, dx))`` of the port's layer in float32, NHWC
    numpy in and out (the layer sees a channels-last NCHW tensor)."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()  # noqa: E731
    return nhwc(y), (bn.weight.grad.numpy(), bn.bias.grad.numpy(), nhwc(xt.grad))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _bf16_ulp(v):
    """One bfloat16 ulp at each element's magnitude."""
    mag = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("shape,k", CASES)
def test_sampled_bn_f32_matches_jax(shape, k):
    v, x, g = _inputs(shape, 1)
    y_ref, stats_ref, (dp, dx_ref) = _jax_vjp(SampledBatchNorm(stats_images=k), v,
                                              jnp.asarray(x), jnp.asarray(g))
    bn = _port_bn(v, k)
    y, (dw, db, dx) = _port_vjp(bn, x, g)
    assert _rel(y, y_ref) < 1e-5
    for got, want in ((dx, dx_ref), (dw, dp["scale"]), (db, dp["bias"])):
        assert _rel(got, want) < 1e-5
    np.testing.assert_allclose(bn.running_mean.numpy(), stats_ref["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats_ref["var"], atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


def test_sampled_bn_statistics_come_from_the_prefix():
    """The images after the first k change neither the running statistics
    nor the normalisation of the first k, and get dx = mul*g."""
    v, x, g = _inputs((4, 6, 6, 32), 2)
    x2 = x.copy()
    x2[2:] = x2[2:] * 3.0 + 5.0
    outs = []
    for xx in (x, x2):
        bn = _port_bn(v, 2)
        y, (_, _, dx) = _port_vjp(bn, xx, g)
        outs.append((y, dx, bn.running_mean.clone(), bn.running_var.clone()))
    (y1, dx1, m1, v1), (y2, dx2, m2, v2) = outs
    np.testing.assert_array_equal(y1[:2], y2[:2])
    assert torch.equal(m1, m2) and torch.equal(v1, v2)
    mul = (v["params"]["scale"] * torch.rsqrt(
        torch.from_numpy(x[:2].reshape(-1, 32)).var(0, unbiased=False) + 1e-5).numpy())
    np.testing.assert_allclose(dx1[2:], g[2:] * mul, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,k", CASES[:3])
def test_sampled_bn_bf16_against_jax(shape, k):
    v, x, g = _inputs(shape, 3)
    xb, gb = _bf16(x), _bf16(g)  # bfloat16 values, held in float32
    mod = SampledBatchNorm(stats_images=k)
    # the JAX function in float32 on the same bfloat16 values
    y32, stats32, (dp32, dx32) = _jax_vjp(mod, v, jnp.asarray(xb), jnp.asarray(gb))
    # the JAX function in a bfloat16 run
    y16, stats16, (dp16, dx16) = _jax_vjp(mod, v, jnp.asarray(xb, jnp.bfloat16),
                                          jnp.asarray(gb, jnp.bfloat16))
    bn = _port_bn(v, k)
    xt = torch.tensor(xb).bfloat16().permute(0, 3, 1, 2).requires_grad_(True)
    yt = bn(xt)
    assert yt.dtype == torch.bfloat16
    yt.backward(torch.from_numpy(gb).bfloat16().permute(0, 3, 1, 2))
    y = yt.detach().float().permute(0, 2, 3, 1).numpy()
    dx = xt.grad.float().permute(0, 2, 3, 1).numpy()
    # against the float32 function: rounded once
    y32, dx32 = np.asarray(y32), np.asarray(dx32)
    # (plus float32 rounding of the terms where they cancel)
    assert (np.abs(y - y32) <= _bf16_ulp(y32) + 1e-6 * np.abs(y32).max()).all()
    assert (np.abs(dx - dx32) <= _bf16_ulp(dx32) + 1e-5 * np.abs(dx32).max()).all()
    for got, want in ((bn.weight.grad, dp32["scale"]), (bn.bias.grad, dp32["bias"])):
        assert _rel(got.numpy(), want) < 1e-5
    # against the bfloat16 function: the measured gap
    y16, dx16 = (np.asarray(a.astype(jnp.float32)) for a in (y16, dx16))
    assert np.abs(y - y16).max() <= 2.0 * _bf16_ulp(np.abs(y16).max())
    assert _rel(dx, dx16) <= 2.0 ** -5
    for got, b16, f32 in ((bn.weight.grad, dp16["scale"], dp32["scale"]),
                          (bn.bias.grad, dp16["bias"], dp32["bias"])):
        assert _rel(got.numpy(), f32) < _rel(np.asarray(b16, np.float32), f32)
    # the statistics come from the same float32 values
    np.testing.assert_allclose(bn.running_mean.numpy(), stats16["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats16["var"], atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (3, 5, 7, 24), (8, 16, 16, 128)])
def test_eval_bn_matches_flax_running_average(shape):
    """The inference-mode layer of frozen stages and ``norm_eval``:
    output in float32 and bfloat16, and the gamma / beta gradients that
    ``norm_eval`` still trains."""
    v, x, g = _inputs(shape, 4)
    ref = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    y_ref, stats, (dp, dx_ref) = _jax_vjp(ref, v, jnp.asarray(x), jnp.asarray(g))
    bn = _port_bn(v, train=False)
    y, (dw, db, dx) = _port_vjp(bn, x, g)
    assert _rel(y, y_ref) < 1e-6
    for got, want in ((dx, dx_ref), (dw, dp["scale"]), (db, dp["bias"])):
        assert _rel(got, want) < 1e-5
    assert torch.equal(bn.running_mean, torch.from_numpy(v["batch_stats"]["mean"]))
    assert int(bn.num_batches_tracked) == 0

    xb = _bf16(x)
    want = np.asarray(fnn.BatchNorm(use_running_average=True, epsilon=1e-5,
                                    dtype=jnp.bfloat16).apply(
        v, jnp.asarray(xb, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = _port_bn(v, train=False)(torch.from_numpy(xb).bfloat16().permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    assert (got != want).mean() < 1e-3
