"""Training BatchNorm on the fused BN kernels.

Counterpart of ``s2anet_tpu/models/bn.py::PallasBatchNorm``. In training
one layer is four passes of :mod:`..ops.moments`, each a CUDA kernel on
the card: forward :func:`bn_stats` (one read of the activation; the
finishing step also gives the normalise coefficients and updates the
running statistics) and :func:`bn_apply` (the normalise: one read, one
write); backward :func:`bn_grad` (one read of the gradient and the
activation; dgamma, dbeta and the dx coefficients) and :func:`bn_dx`. In
eval it is the plain affine with the running statistics.

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

from ..ops.moments import bn_apply, bn_dx, bn_grad, bn_stats


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _BatchNormTrain(torch.autograd.Function):
    """``y`` of the BN layer ``bn`` in training; its batch statistics update
    the layer's running statistics. The statistics carry no gradient of
    their own: the backward is the closed form, which accounts for them."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        xl = _nhwc(x)
        mean, _, rstd, mul = bn_stats(xl, weight, bn.running_mean, bn.running_var,
                                      bn.num_batches_tracked, bn.eps,
                                      1.0 - bn.momentum)  # flax momentum
        ctx.save_for_backward(x)
        ctx.stats = mean, rstd, mul
        return bn_apply(xl, mean, mul, bias).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        mean, rstd, mul = ctx.stats
        xl, gl = _nhwc(x), _nhwc(gy)
        # dx = gamma*rstd * (g - mean(g) - xhat * mean(g*xhat))
        dgamma, dbeta, a, b = bn_grad(gl, xl, mean, rstd)
        dx = bn_dx(gl, xl, mean, mul, a, b)
        return dx.permute(0, 3, 1, 2), dgamma, dbeta, None


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = self.weight * torch.rsqrt(self.running_var + self.eps)
            y = (_nhwc(x).float() - self.running_mean) * mul + self.bias
            return y.to(x.dtype).permute(0, 3, 1, 2)
        return _BatchNormTrain.apply(x, self.weight, self.bias, self)
