"""Training BatchNorm on the fused BN kernels.

Counterpart of ``s2anet_tpu/models/bn.py::PallasBatchNorm``. In training
one layer is four passes of :mod:`..ops.moments`, each a CUDA kernel on
the card: forward :func:`bn_stats` (one read of the activation; the
finishing step also gives the normalise coefficients and updates the
running statistics) and :func:`bn_apply` (the normalise: one read, one
write); backward :func:`bn_grad` (one read of the gradient and the
activation; dgamma, dbeta and the dx coefficients) and :func:`bn_dx`. In
eval it is the plain affine with the running statistics, in float32, as
flax's ``use_running_average=True``; gamma and beta still get gradients
(a frozen stage or ``norm_eval`` puts a layer in eval while it trains:
``models/resnet.py``).

``stats_images = k > 0`` is the JAX ``SampledBatchNorm``: the statistics
(and the running statistics' update) come from the first ``min(k, N)``
images, and the whole batch is normalised with them. On the same four
passes: :func:`bn_stats` reads only those images' rows (the leading rows
of the channels-last activation: no copy), :func:`bn_grad` sums over all
rows and finishes with the count of the statistics' rows, and
:func:`bn_dx` runs twice, on the statistics' rows with the dx
coefficients and on the rest with ``a = b = 0`` (there ``dx = mul*g``:
those rows did not move the statistics). The JAX function normalises a
bfloat16 input in bfloat16 arithmetic (mean, mul and bias rounded to
bfloat16 first); here the normalise is float32 inside, rounded once, as
the full-batch layer.

Data parallel (a process group of more than one rank,
``parallel/mesh.py``): the statistics are those of the global batch, as
the JAX package's ``shard_map`` + ``psum`` (``s2anet_tpu/models/bn.py``).
Each rank sums its rows without finishing (:func:`moment_sums`,
:func:`pair_sums`), the ``[2, C]`` sums are all-reduced, and the
elementwise pass finishes them with the global row count:
:func:`bn_apply_finish` (statistics, running statistics and ``y``) and
:func:`bn_dx_finish` (dgamma, dbeta and ``dx``), one kernel each on the
card, so a layer is two launches a direction as in one process. Sampled
statistics take the first ``k`` images of the global batch: rank ``r``
holds global images ``[r*b, (r+1)*b)``, so its statistics rows are those
of ``clamp(k - r*b, 0, b)`` images (none: zero sums, and dx with ``a = b =
0`` on every row). The backward returns dgamma and dbeta of the global
batch, already summed over the ranks (the train step leaves them out of its
gradient sum, ``parallel/step.py``).

It mirrors flax's ``nn.BatchNorm``, not torch's:

* var = max(E[x^2] - E[x]^2, 0), statistics and normalisation in float32,
  the output cast to the input's type;
* the running variance takes the biased batch variance (torch's own
  BatchNorm stores the unbiased one); flax momentum 0.9 is torch momentum
  0.1; eps 1e-5.

The module keeps ``nn.BatchNorm2d``'s keys and type (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so weight
conversion and serving-time folding treat it as one. The activation is
``[N, C, H, W]``; training reads it and its gradient as ``[N, H, W, C]``,
so both must be channels-last in memory on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.moments import (bn_apply, bn_apply_finish, bn_dx, bn_dx_finish, bn_grad, bn_stats,
                           moment_sums, pair_sums)
from ..parallel import mesh


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def stats_images(stats_images: int, b: int, rank: int = 0, world: int = 1):
    """``(k, k_global)``: the images of this rank's batch of ``b`` that the
    statistics come from, and their count over the global batch of ``b *
    world`` (all of them, or its first ``max(1, min(stats_images, b *
    world))`` when ``stats_images > 0``)."""
    total = b * world
    kg = total if stats_images <= 0 else max(1, min(stats_images, total))
    return min(max(kg - rank * b, 0), b), kg


class _BatchNormTrain(torch.autograd.Function):
    """``y`` of the BN layer ``bn`` in training; the statistics of its first
    ``k`` images (all of them unless ``bn.stats_images``) update the
    layer's running statistics. The statistics carry no gradient of their
    own: the backward is the closed form, which accounts for them."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        xl = _nhwc(x)
        world = mesh.world_size()
        k, kg = stats_images(bn.stats_images, x.shape[0], mesh.rank(), world)
        n = kg * xl.shape[1] * xl.shape[2]  # the statistics' rows, all ranks
        keep = 1.0 - bn.momentum  # flax momentum
        run = (bn.running_mean, bn.running_var, bn.num_batches_tracked, bn.eps, keep)
        if world == 1:
            mean, _, rstd, mul = bn_stats(xl[:k], weight, *run)
            y = bn_apply(xl, mean, mul, bias)
        else:
            sums = mesh.all_reduce_sum(moment_sums(xl[:k]))
            y, (mean, _, rstd, mul) = bn_apply_finish(xl, sums, n, weight, bias, *run)
        ctx.save_for_backward(x)
        ctx.stats = mean, rstd, mul, k, n, world > 1
        return y.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        mean, rstd, mul, k, n, summed = ctx.stats
        xl, gl = _nhwc(x), _nhwc(gy)
        # on the statistics' rows dx = gamma*rstd * (g - sum(g)/n
        # - xhat * sum(g*xhat)/n), n their count; sums over every row
        if summed:
            sums = mesh.all_reduce_sum(pair_sums(gl, xl))
            dx, dgamma, dbeta = bn_dx_finish(gl, xl, sums, n, mean, rstd, mul,
                                             k * xl.shape[1] * xl.shape[2])
            return dx.permute(0, 3, 1, 2), dgamma, dbeta, None
        dgamma, dbeta, a, b = bn_grad(gl, xl, mean, rstd, n)
        if k == x.shape[0]:
            dx = bn_dx(gl, xl, mean, mul, a, b)
        else:
            dx = torch.empty_like(xl)
            if k:
                bn_dx(gl[:k], xl[:k], mean, mul, a, b, out=dx[:k])
            zero = torch.zeros_like(a)
            bn_dx(gl[k:], xl[k:], mean, mul, zero, zero, out=dx[k:])
        return dx.permute(0, 3, 1, 2), dgamma, dbeta, None


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, num_features: int, stats_images: int = 0):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.stats_images = stats_images  # > 0: sampled statistics (see above)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = self.weight * torch.rsqrt(self.running_var + self.eps)
            y = (_nhwc(x).float() - self.running_mean) * mul + self.bias
            return y.to(x.dtype).permute(0, 3, 1, 2)
        return _BatchNormTrain.apply(x, self.weight, self.bias, self)
