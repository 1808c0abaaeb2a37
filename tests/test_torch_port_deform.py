"""The port's AlignConv forward (plain version) against the JAX package.

The JAX side runs the gather path ``deform_conv2d(offset_grad=False)`` and
the TPU kernel ``deform_conv2d_hat`` in interpret mode, on the shapes of
tests/test_pallas_deform.py plus a 1x1 map, in float32 at 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from s2anet_tpu.ops.pallas.deform_kernel import deform_conv2d_hat
from s2anet_tpu_torch.ops import deform_conv


def _case(rng, b, h, w, c, cout, off_scale=1.5):
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    off = (rng.normal(size=(b, h, w, 9, 2)) * off_scale).astype(np.float32)
    wgt = (rng.normal(size=(3, 3, c, cout)) * 0.1).astype(np.float32)
    return x, off, wgt


def _port(x, off, wgt):
    return deform_conv.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                                     torch.from_numpy(wgt)).numpy()


@pytest.mark.parametrize("shape", [(2, 32, 32, 8, 4), (1, 9, 11, 8, 4),
                                   (2, 16, 48, 8, 8), (2, 1, 1, 8, 4)])
def test_matches_jax_gather_and_hat(rng, shape):
    x, off, wgt = _case(rng, *shape)
    got = _port(x, off, wgt)
    gather = np.asarray(jax_deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                                          jnp.asarray(wgt), offset_grad=False))
    hat = np.asarray(deform_conv2d_hat(jnp.asarray(x), jnp.asarray(off),
                                       jnp.asarray(wgt), interpret=True))
    np.testing.assert_allclose(got, gather, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, hat, rtol=1e-4, atol=1e-4)


def test_far_outside_and_large_offsets(rng):
    """Samples far outside the image are exact zeros; offsets that leave
    any TPU window (no fallback needed here) still match the gather path."""
    x, off, wgt = _case(rng, 1, 12, 20, 8, 4, off_scale=6.0)
    off[0, 2, 2, :, 0] = -500.0
    off[0, 5, 5, 3, 0] = 25.0
    got = _port(x, off, wgt)
    want = np.asarray(jax_deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                                        jnp.asarray(wgt), offset_grad=False))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_zero_offsets_equal_plain_conv(rng):
    x, off, wgt = _case(rng, 2, 7, 9, 8, 4)
    off[:] = 0.0
    got = _port(x, off, wgt)
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(wgt).permute(3, 2, 0, 1), padding=1)
    np.testing.assert_allclose(got, conv.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_bf16_rounds_samples_and_keeps_f32_coords(rng):
    """bf16 in -> bf16 out, with coordinates in float32: a +0.25-cell x
    offset at x ~ 120 must not snap to the bf16 grid (ulp 0.5 there)."""
    b, h, w, c = 1, 2, 128, 4
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    off = np.zeros((b, h, w, 9, 2), np.float32)
    off[..., 1] = 0.25
    wgt = np.zeros((3, 3, c, c), np.float32)
    wgt[1, 1] = np.eye(c)  # centre tap only: out = sample(x, h, w + 0.25)
    xb = torch.from_numpy(x).bfloat16()
    got = deform_conv.deform_conv2d(xb, torch.from_numpy(off).bfloat16(),
                                    torch.from_numpy(wgt).bfloat16())
    assert got.dtype == torch.bfloat16
    xf = xb.float().numpy()
    want = 0.75 * xf[:, :, :-1] + 0.25 * xf[:, :, 1:]
    np.testing.assert_allclose(got.float().numpy()[:, :, :-1], want,
                               rtol=1e-2, atol=1e-2)


def test_cpu_tensor_takes_plain_version(rng):
    x, off, wgt = _case(rng, 1, 5, 6, 4, 4)
    before = deform_conv.DEFORM_FWD.launches
    a = _port(x, off, wgt)
    b = deform_conv.deform_conv2d_plain(torch.from_numpy(x), torch.from_numpy(off),
                                        torch.from_numpy(wgt)).numpy()
    np.testing.assert_array_equal(a, b)
    assert deform_conv.DEFORM_FWD.launches == before


def test_cuda_wrapper_rejects_cpu_tensors(rng):
    x, off, wgt = (torch.from_numpy(a) for a in _case(rng, 1, 4, 4, 4, 4))
    with pytest.raises(ValueError):
        deform_conv.deform_conv2d_cuda(x, off, wgt)
