"""The AlignConv backward of the port against the JAX package.

The port's CPU path differentiates ``deform_conv2d_plain`` with autograd;
:func:`deform_conv2d_bwd_plain` is that backward as a function, the plain
version of the CUDA backward kernel. Both are held at 1e-3 against the
gather path's custom VJP (``offset_grad=False``) and against the Pallas hat
kernel's VJP in interpret mode, on the shapes of
``tests/test_pallas_deform.py`` (loss = sum of squared outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.ops.deform_conv import deform_conv2d as jax_deform
from s2anet_tpu.ops.pallas.deform_kernel import deform_conv2d_hat
from s2anet_tpu_torch.ops import deform_conv as dc


def _case(seed, b, h, w, c, cout, off_scale=1.5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    off = (rng.normal(size=(b, h, w, 9, 2)) * off_scale).astype(np.float32)
    wgt = (rng.normal(size=(3, 3, c, cout)) * 0.1).astype(np.float32)
    return x, off, wgt


def _port_grads(x, off, wgt):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(wgt).requires_grad_(True)
    (dc.deform_conv2d(xt, torch.from_numpy(off), wt) ** 2).sum().backward()
    return xt.grad.numpy(), wt.grad.numpy()


def _jax_grads(fn, x, off, wgt):
    def loss(xx, ww):
        return (fn(xx, jnp.asarray(off), ww) ** 2).sum()
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(wgt))]


@pytest.mark.parametrize("shape", [(2, 32, 32, 8, 4), (1, 19, 41, 8, 4)])
def test_deform_grads_match_jax_gather_and_hat(shape):
    x, off, wgt = _case(7, *shape)
    got = _port_grads(x, off, wgt)
    gather = _jax_grads(lambda a, o, w: jax_deform(a, o, w, offset_grad=False),
                        x, off, wgt)
    hat = _jax_grads(lambda a, o, w: deform_conv2d_hat(a, o, w, interpret=True),
                     x, off, wgt)
    for want in (gather, hat):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


def test_deform_bwd_plain_is_the_autograd_backward():
    """The plain backward (the CUDA kernel's reference) equals autograd of
    the plain forward; far-off samples get no gradient."""
    x, off, wgt = _case(3, 1, 9, 11, 8, 4, off_scale=3.0)
    off[0, :2, :, :3, 0] -= 500.0
    rng = np.random.default_rng(4)
    g = rng.normal(size=(1, 9, 11, 4)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(wgt).requires_grad_(True)
    dc.deform_conv2d_plain(xt, torch.from_numpy(off), wt).backward(torch.from_numpy(g))
    dx, dw = dc.deform_conv2d_bwd_plain(torch.from_numpy(x), torch.from_numpy(off),
                                        torch.from_numpy(wgt), torch.from_numpy(g))
    torch.testing.assert_close(dx, xt.grad, rtol=0, atol=0)
    torch.testing.assert_close(dw, wt.grad, rtol=0, atol=0)
    assert dx.dtype == torch.float32 and dw.shape == (3, 3, 8, 4)
