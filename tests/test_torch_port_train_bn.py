"""The moment reductions and the training BatchNorm against the JAX package.

* ``channel_moments`` / ``grad_channel_sums`` (the plain versions on the
  CPU) against the Pallas kernels in interpret mode, rtol 1e-5.
* ``models.bn.BatchNorm2d`` in train mode against ``PallasBatchNorm``
  (interpret) and flax ``nn.BatchNorm``: output 1e-5, running statistics
  1e-6, gradients as tests/test_pallas_bn.py holds PallasBatchNorm to flax;
  eval mode and the bf16 output type.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.models.bn import PallasBatchNorm
from s2anet_tpu.ops.pallas.moments import channel_moments as jax_moments
from s2anet_tpu.ops.pallas.moments import grad_channel_sums as jax_pair
from s2anet_tpu_torch.models.bn import BatchNorm2d
from s2anet_tpu_torch.ops import moments


def _rand(shape, seed, loc=0.0, scale=1.0):
    return np.random.default_rng(seed).normal(loc, scale, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 8, 8, 64), (2, 16, 16, 128), (2, 4, 4, 256)])
def test_moments_match_pallas(shape):
    x = _rand(shape, 1, loc=0.7, scale=1.3)
    g = _rand(shape, 2)
    s, q = moments.channel_moments(torch.from_numpy(x))
    ws, wq = jax_moments(jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(wq), rtol=1e-5)
    sg, sgx = moments.grad_channel_sums(torch.from_numpy(g), torch.from_numpy(x))
    wg, wgx = jax_pair(jnp.asarray(g), jnp.asarray(x), interpret=True)
    # sums of mixed signs: relative to the sum of magnitudes
    mag_g = np.abs(g).reshape(-1, shape[-1]).sum(0)
    mag_gx = np.abs(g * x).reshape(-1, shape[-1]).sum(0)
    assert (np.abs(sg.numpy() - np.asarray(wg)) <= 1e-5 * mag_g).all()
    assert (np.abs(sgx.numpy() - np.asarray(wgx)) <= 1e-5 * mag_gx).all()


def test_moments_bf16_sum_in_f32():
    x = torch.ones(8, 8, 8, 128, dtype=torch.bfloat16)
    s, q = moments.channel_moments(x)
    assert s.dtype == torch.float32
    assert (s == 512.0).all() and (q == 512.0).all()


def _variables(c=64, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.normal(0, 0.3, c).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.2, c).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, c).astype(np.float32)},
    }


def _port_bn(v, train=True):
    c = v["params"]["scale"].shape[0]
    bn = BatchNorm2d(c)
    bn.load_state_dict({
        "weight": torch.from_numpy(v["params"]["scale"]),
        "bias": torch.from_numpy(v["params"]["bias"]),
        "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(v["batch_stats"]["var"]),
        "num_batches_tracked": torch.tensor(0)})
    return bn.train(train)


def _nchw(x):
    """NHWC numpy -> [N, C, H, W] channels-last tensor."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("ref", ["flax", "pallas"])
def test_bn_train_forward_and_running_stats(ref):
    x = _rand((4, 8, 8, 64), 8, loc=1.0, scale=2.0)
    v = _variables()
    mod = (fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
           if ref == "flax" else PallasBatchNorm(interpret=True))
    y_ref, upd = mod.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    bn = _port_bn(v)
    y = bn(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("ref", ["flax", "pallas"])
def test_bn_grads_match(ref):
    x = _rand((4, 8, 8, 64), 9, loc=1.0, scale=2.0)
    v = _variables()
    mod = (fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
           if ref == "flax" else PallasBatchNorm(interpret=True))

    def f(params, xx):
        y, _ = mod.apply({"params": params, "batch_stats": v["batch_stats"]},
                         xx, mutable=["batch_stats"])
        return jnp.sin(y).sum()

    g_params, g_x = jax.grad(f, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, v["params"]), jnp.asarray(x))
    bn = _port_bn(v)
    xt = _nchw(x).requires_grad_(True)
    torch.sin(bn(xt)).sum().backward()
    for a, b in ((g_params["scale"], bn.weight.grad), (g_params["bias"], bn.bias.grad),
                 (g_x, xt.grad.permute(0, 2, 3, 1))):
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1.0)
        assert float(np.abs(a - b.numpy()).max()) / scale < 1e-5


def test_bn_eval_and_bf16():
    v = _variables()
    x = _rand((2, 8, 8, 64), 10)
    want = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(v, jnp.asarray(x))
    got = _port_bn(v, train=False)(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)

    xb = jnp.asarray(_rand((4, 8, 8, 64), 11, loc=1.0)).astype(jnp.bfloat16)
    want, _ = PallasBatchNorm(interpret=True).apply(v, xb, mutable=["batch_stats"])
    got = _port_bn(v)(_nchw(np.array(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().permute(0, 2, 3, 1).detach().numpy()
               - np.asarray(want.astype(jnp.float32)))
    assert d.max() < 0.05  # one bf16 ulp at the output magnitude
