"""The fused training BatchNorm's plain versions against the JAX package.

The port's stats (with the running-statistics update), apply, backward
coefficients and dx functions, and ``models.bn.BatchNorm2d`` in train mode
through them, against ``s2anet_tpu.models.bn.bn_train_apply`` with the
Pallas moment kernels in interpret mode: its forward, and ``jax.vjp`` for
dx, dgamma and dbeta. Inputs from a numpy seed. float32 within 1e-5 of the
largest reference value; a bfloat16 output within one bfloat16 ulp of the
reference element (the statistics differ only by float32 summation order);
running statistics within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.models.bn import bn_train_apply
from s2anet_tpu_torch.models.bn import BatchNorm2d
from s2anet_tpu_torch.ops import moments as mo

EPS, KEEP = 1e-5, 0.9  # flax momentum
SHAPES = [(4, 8, 8, 64), (2, 4, 4, 256), (3, 5, 7, 24)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _case(shape, dtype, seed):
    """NHWC input and output gradient in both frameworks (the same values),
    and float32 weight, bias and running statistics."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    tdt, jdt = DTYPES[dtype]
    x = torch.from_numpy(rng.normal(1.0, 2.0, shape).astype(np.float32)).to(tdt)
    g = torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(np.float32)).to(tdt)
    v = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.3, c),
         "running_mean": rng.normal(0, 0.2, c), "running_var": rng.uniform(0.5, 2.0, c)}
    v = {k: a.astype(np.float32) for k, a in v.items()}
    jx, jg = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (x, g))
    return x, g, jx, jg, v


def _jax_ref(jx, jg, v):
    """``(y, mean, var)`` of bn_train_apply, its vjp ``(dx, dgamma, dbeta)``
    for the output gradient, and the running statistics after the update."""
    def f(xx, s, b):
        return bn_train_apply(xx, s, b, EPS, None, True, jx.dtype)

    (y, mean, var), vjp = jax.vjp(f, jx, jnp.asarray(v["weight"]), jnp.asarray(v["bias"]))
    zero = jnp.zeros_like(mean)
    dx, dgamma, dbeta = vjp((jg, zero, zero))
    rm = KEEP * jnp.asarray(v["running_mean"]) + (1 - KEEP) * mean
    rv = KEEP * jnp.asarray(v["running_var"]) + (1 - KEEP) * var
    return {"y": y, "mean": mean, "var": var, "dx": dx, "dgamma": dgamma,
            "dbeta": dbeta, "running_mean": rm, "running_var": rv}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_close(got, want, name):
    """float32: within 1e-5 of the largest |want|; bfloat16: within one
    bfloat16 ulp of each element of ``want``."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, name
    if getattr(want, "dtype", None) == jnp.bfloat16:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
        worst = float((np.abs(g - w) / ulp).max())
        assert worst <= 1.0, f"{name}: {worst:.3g} bf16 ulp"
    else:
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= 1e-5, f"{name}: {err:.3g} of the largest value"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_stats_and_apply_match_jax(shape, dtype):
    x, g, jx, jg, v = _case(shape, dtype, 1)
    ref = _jax_ref(jx, jg, v)
    # copies: the update below is in place, and the JAX reference, dispatched
    # asynchronously, may read v's arrays after it
    rm, rv = (torch.from_numpy(v[k].copy()) for k in ("running_mean", "running_var"))
    tracked = torch.tensor(0)
    mean, var, rstd, mul = mo.bn_stats_plain(x, torch.from_numpy(v["weight"]), rm, rv,
                                             tracked, EPS, KEEP)
    assert int(tracked) == 1
    y = mo.bn_apply_plain(x, mean, mul, torch.from_numpy(v["bias"]))
    assert y.dtype == x.dtype and mean.dtype == torch.float32
    _assert_close(y, ref["y"], "y")
    _assert_close(mean, ref["mean"], "mean")
    _assert_close(var, ref["var"], "var")
    for name, got in (("running_mean", rm), ("running_var", rv)):
        np.testing.assert_allclose(got.numpy(), _f32(ref[name]), rtol=0, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(_f32(ref["var"]) + EPS), rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_grad_and_dx_match_jax_vjp(shape, dtype):
    x, g, jx, jg, v = _case(shape, dtype, 2)
    ref = _jax_ref(jx, jg, v)
    mean, _, rstd, mul = mo.bn_stats_plain(
        x, torch.from_numpy(v["weight"]), torch.from_numpy(v["running_mean"]),
        torch.from_numpy(v["running_var"]), torch.tensor(0), EPS, KEEP)
    dgamma, dbeta, a, b = mo.bn_grad_plain(g, x, mean, rstd)
    dx = mo.bn_dx_plain(g, x, mean, mul, a, b)
    assert dx.dtype == x.dtype and dgamma.dtype == torch.float32
    for name, got in (("dx", dx), ("dgamma", dgamma), ("dbeta", dbeta)):
        _assert_close(got, ref[name], name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_module_train_matches_jax(shape, dtype):
    x, g, jx, jg, v = _case(shape, dtype, 3)
    ref = _jax_ref(jx, jg, v)
    bn = BatchNorm2d(shape[-1])
    bn.load_state_dict({**{k: torch.from_numpy(a) for k, a in v.items()},
                        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    xt = x.permute(0, 3, 1, 2).detach().requires_grad_(True)  # channels-last NCHW
    y = bn(xt)
    y.backward(g.permute(0, 3, 1, 2))
    assert int(bn.num_batches_tracked) == 1
    _assert_close(y.permute(0, 2, 3, 1), ref["y"], "y")
    _assert_close(xt.grad.permute(0, 2, 3, 1), ref["dx"], "dx")
    _assert_close(bn.weight.grad, ref["dgamma"], "dgamma")
    _assert_close(bn.bias.grad, ref["dbeta"], "dbeta")
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(), _f32(ref[name]), rtol=0,
                                   atol=1e-6, err_msg=name)
