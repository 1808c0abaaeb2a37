"""The data-parallel BN layer's fused finishing: plain versions and checks.

Across ranks the BN layer all-reduces its ``[2, C]`` sums, and one kernel a
direction finishes them inside the elementwise pass:
``ops.moments.bn_apply_finish`` (statistics, running statistics, ``y``) and
``bn_dx_finish`` (dgamma, dbeta, ``dx`` with ``a = b = 0`` on the rows at
or past ``stat_rows``). Here, on the CPU, their plain versions:

* bit for bit equal to the plain finishing step followed by the plain
  apply, or the plain dx on the two row ranges (what the layer ran before
  the fusion), at several C, float32 and bfloat16, ``stat_rows`` none, a
  prefix and all; the running statistics and the batch count updated once;
* the plain finishing half against the JAX package's psum'd finishing math
  (``s2anet_tpu/models/bn.py`` ``_bn_fwd_math`` and ``_bn_bwd``, their
  ``_global_moments`` / ``_global_pair`` handing back the same numpy sums)
  within 1e-6 of the largest reference value;
* ``models.bn.BatchNorm2d``'s data-parallel branch in one process (a world
  of two ranks holding the same images: the all-reduce doubles) against one
  process on both copies, through one fused call a direction;
* the CUDA wrappers' input checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s2anet_tpu.models.bn as jbn
from s2anet_tpu_torch.models import bn as bn_mod
from s2anet_tpu_torch.models.bn import BatchNorm2d
from s2anet_tpu_torch.ops import moments as mo
from s2anet_tpu_torch.parallel import mesh

EPS, KEEP = 1e-5, 0.9  # flax momentum
CHANNELS = [8, 24, 64, 256]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
IMAGES, H, W = 3, 5, 4


def _case(c: int, dtype, seed: int = 0):
    """An NHWC input and output gradient, float32 weight and bias, running
    statistics and a count, and all-reduced sums: the statistics images' sums
    of two ranks holding the same images (twice one rank's)."""
    rng = np.random.default_rng(seed + c)
    shape = (IMAGES, H, W, c)
    x = torch.from_numpy(rng.normal(1.0, 2.0, shape).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(np.float32)).to(dtype)
    vec = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.3, c),
           "running_mean": rng.normal(0, 0.2, c), "running_var": rng.uniform(0.5, 2.0, c)}
    vec = {k: torch.from_numpy(a.astype(np.float32)) for k, a in vec.items()}
    return x, g, vec


def _running(vec):
    return vec["running_mean"].clone(), vec["running_var"].clone(), torch.tensor(5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CHANNELS)
def test_apply_finish_plain_equals_finish_then_apply(c, dtype):
    x, _, vec = _case(c, DTYPES[dtype])
    sums = 2 * mo.moment_sums_plain(x[:2])
    n = 2 * 2 * H * W
    want_run = _running(vec)
    stats = mo.bn_finish_stats_plain(sums, n, vec["weight"], *want_run, EPS, KEEP)
    want_y = mo.bn_apply_plain(x, stats[0], stats[3], vec["bias"])
    run = _running(vec)
    y, got = mo.bn_apply_finish(x, sums, n, vec["weight"], vec["bias"], *run, EPS, KEEP)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert torch.equal(y, want_y)
    for a, b in zip(got + run, stats + want_run):
        assert torch.equal(a, b)
    assert int(run[2]) == 6  # one batch tracked, once
    assert not torch.equal(run[0], vec["running_mean"])


@pytest.mark.parametrize("images", [0, 1, IMAGES])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CHANNELS)
def test_dx_finish_plain_equals_finish_then_two_range_dx(c, dtype, images):
    """``stat_rows`` = the rows of ``images`` images: none (a rank whose
    statistics prefix ended on an earlier rank), a prefix, all; the
    reference is the layer's backward before the fusion."""
    x, g, vec = _case(c, DTYPES[dtype])
    run = _running(vec)
    n = 2 * IMAGES * H * W
    mean, _, rstd, mul = mo.bn_finish_stats_plain(2 * mo.moment_sums_plain(x), n,
                                                  vec["weight"], *run, EPS, KEEP)
    sums = 2 * mo.pair_sums_plain(g, x)
    dgamma, dbeta, a, b = mo.bn_finish_grad_plain(sums, n, mean, rstd)
    if images == IMAGES:
        want = mo.bn_dx_plain(g, x, mean, mul, a, b)
    else:
        want = torch.empty_like(x)
        if images:
            mo.bn_dx_plain(g[:images], x[:images], mean, mul, a, b, out=want[:images])
        zero = torch.zeros_like(a)
        mo.bn_dx_plain(g[images:], x[images:], mean, mul, zero, zero, out=want[images:])
    dx, got_dgamma, got_dbeta = mo.bn_dx_finish(g, x, sums, n, mean, rstd, mul,
                                                images * H * W)
    assert dx.dtype == x.dtype and dx.shape == x.shape
    assert torch.equal(dx, want)
    assert torch.equal(got_dgamma, dgamma) and torch.equal(got_dbeta, dbeta)
    if images < IMAGES:  # the rows past the prefix: dx = mul*g, rounded
        assert torch.equal(dx[images:], (mul * g[images:].float()).to(x.dtype))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("c", [8, 24, 64])
def test_plain_finish_matches_jax_psum_finish(c, monkeypatch):
    """The JAX package's finishing math on psum'd sums, fed the same numpy
    sums (its ``_global_moments`` / ``_global_pair`` patched to return
    them) over the global batch of ``n`` rows, in float32."""
    rng = np.random.default_rng(c)
    rows = 2 * IMAGES * H * W  # the global batch: JAX takes n from x
    x = rng.normal(1.0, 2.0, (rows, c)).astype(np.float32)
    g = rng.normal(0.0, 1.0, (rows, c)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.3, c).astype(np.float32)
    rm0 = rng.normal(0, 0.2, c).astype(np.float32)
    rv0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    xd, gd = x.astype(np.float64), g.astype(np.float64)
    msums = np.stack([xd.sum(0), (xd * xd).sum(0)]).astype(np.float32)
    psums = np.stack([gd.sum(0), (gd * xd).sum(0)]).astype(np.float32)
    monkeypatch.setattr(jbn, "_global_moments",
                        lambda xs, m, i: (jnp.asarray(msums[0]), jnp.asarray(msums[1])))
    monkeypatch.setattr(jbn, "_global_pair",
                        lambda gs, xs, m, i: (jnp.asarray(psums[0]), jnp.asarray(psums[1])))
    jx, jg, jw = jnp.asarray(x), jnp.asarray(g), jnp.asarray(w)
    jy, jmean, jvar = jbn._bn_fwd_math(jx, jw, jnp.asarray(bias), EPS, None, True, jnp.float32)
    zero = jnp.zeros_like(jmean)
    jdx, jdgamma, jdbeta = jbn._bn_bwd(EPS, None, True, jnp.float32, (jx, jw, jmean, jvar),
                                       (jg, zero, zero))

    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    rm, rv, tracked = torch.from_numpy(rm0.copy()), torch.from_numpy(rv0.copy()), torch.tensor(0)
    y, (mean, var, rstd, mul) = mo.bn_apply_finish(tx, torch.from_numpy(msums), rows,
                                                   torch.from_numpy(w), torch.from_numpy(bias),
                                                   rm, rv, tracked, EPS, KEEP)
    dx, dgamma, dbeta = mo.bn_dx_finish(tg, tx, torch.from_numpy(psums), rows, mean, rstd, mul,
                                        rows)
    assert _rel(mean, jmean) <= 1e-6 and _rel(var, jvar) <= 1e-6
    assert _rel(rm, KEEP * rm0 + (1 - KEEP) * np.asarray(jmean)) <= 1e-6
    assert _rel(rv, KEEP * rv0 + (1 - KEEP) * np.asarray(jvar)) <= 1e-6
    assert int(tracked) == 1
    assert _rel(dgamma, jdgamma) <= 1e-6 and _rel(dbeta, jdbeta) <= 1e-6
    assert _rel(y, jy) <= 1e-6 and _rel(dx, jdx) <= 1e-6


class _TwoSameRanks:
    """``models.bn``'s view of a world of two ranks that hold the same
    images, this process rank 0: the all-reduce doubles."""

    def __init__(self, monkeypatch):
        monkeypatch.setattr(mesh, "world_size", lambda: 2)
        monkeypatch.setattr(mesh, "rank", lambda: 0)
        monkeypatch.setattr(mesh, "all_reduce_sum", lambda t: t.mul_(2))
        self.calls = {}
        for name in ("bn_apply_finish", "bn_dx_finish", "bn_stats", "bn_apply", "bn_grad",
                     "bn_dx"):
            monkeypatch.setattr(bn_mod, name, self._counted(name, getattr(bn_mod, name)))

    def _counted(self, name, fn):
        def call(*args, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kw)
        return call


def _bn_train(x, g, w, b):
    bn = BatchNorm2d(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    x = x.clone().requires_grad_()
    y = bn(x)
    y.backward(g)
    return [t.detach() for t in (y, x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
                                 bn.running_var)]


@pytest.mark.parametrize("c", [8, 64])
def test_data_parallel_layer_one_fused_call_a_direction(c, monkeypatch):
    """float32, NCHW: the rank's outputs, dx and the global dgamma, dbeta
    and running statistics against one process on both copies of the
    images, within 1e-5 of the largest value (sums added in another order);
    one bn_apply_finish and one bn_dx_finish, no one-process call."""
    x, g, vec = _case(c, torch.float32)
    x, g = x.permute(0, 3, 1, 2).contiguous(), g.permute(0, 3, 1, 2).contiguous()
    want = _bn_train(torch.cat([x, x]), torch.cat([g, g]), vec["weight"], vec["bias"])
    world = _TwoSameRanks(monkeypatch)
    got = _bn_train(x, g, vec["weight"], vec["bias"])
    assert world.calls == {"bn_apply_finish": 1, "bn_dx_finish": 1}
    for i, (a, b) in enumerate(zip(got, want)):
        b = b[:IMAGES] if i < 2 else b
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), i


def _cuda_args(c=64, rows=12, dtype=torch.bfloat16):
    x = torch.zeros(rows, c, dtype=dtype)
    sums = torch.zeros(2, c)
    vec = torch.ones(c)
    return x, sums, vec


@pytest.mark.parametrize("case,match", [
    ("n", "n = 0"),
    ("sums_shape", r"float32 \[2, 64\]"),
    ("sums_dtype", r"float32 \[2, 64\]"),
    ("cpu", "takes CUDA tensors"),
])
def test_apply_finish_wrapper_checks(case, match):
    x, sums, vec = _cuda_args()
    n = 0 if case == "n" else 12
    if case == "sums_shape":
        sums = torch.zeros(3, 64)
    if case == "sums_dtype":
        sums = sums.double()
    with pytest.raises(ValueError, match=match):
        mo.bn_apply_finish_cuda(x, sums, n, vec, vec, vec.clone(), vec.clone(), torch.tensor(0),
                                EPS, KEEP)


@pytest.mark.parametrize("stat_rows,match", [
    (-1, r"stat_rows = -1 outside \[0, 12\]"),
    (13, r"stat_rows = 13 outside \[0, 12\]"),
    (12, "takes CUDA tensors"),
])
def test_dx_finish_wrapper_checks(stat_rows, match):
    x, sums, vec = _cuda_args()
    with pytest.raises(ValueError, match=match):
        mo.bn_dx_finish_cuda(x, x, sums, 12, vec, vec, vec, stat_rows)
