"""Training BatchNorm on the moment kernels.

Counterpart of ``s2anet_tpu/models/bn.py::PallasBatchNorm``. In training the
batch statistics come from :func:`..ops.moments.channel_moments` (one read
of the activation) and the backward from
:func:`..ops.moments.grad_channel_sums` (one read of the gradient and the
activation) plus the closed-form dx. In eval it is the plain affine with the
running statistics.

It mirrors flax's ``nn.BatchNorm``, not torch's:

* var = max(E[x^2] - E[x]^2, 0), statistics and normalisation in float32,
  the output cast to the input's type;
* the running variance takes the biased batch variance (torch's own
  BatchNorm stores the unbiased one); flax momentum 0.9 is torch momentum
  0.1; eps 1e-5.

The module keeps ``nn.BatchNorm2d``'s keys and type (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so weight
conversion and serving-time folding treat it as one. The activation is
``[N, C, H, W]``; training reads it as ``[N, H, W, C]``, so it must be
channels-last in memory on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.moments import channel_moments, grad_channel_sums


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _BatchNormTrain(torch.autograd.Function):
    """``(y, batch mean, biased batch var)``; mean and var carry no
    gradient (they feed only the running averages)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xl = _nhwc(x)
        n = xl.numel() // xl.shape[-1]
        s, q = channel_moments(xl)
        mean = s / n
        var = torch.clamp_min(q / n - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        y = ((xl.float() - mean) * (weight * rstd) + bias).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y.permute(0, 3, 1, 2), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, rstd = ctx.saved_tensors
        xl, gl = _nhwc(x), _nhwc(gy)
        n = xl.numel() // xl.shape[-1]
        sg, sgx = grad_channel_sums(gl, xl)
        dbeta = sg
        dgamma = (sgx - mean * sg) * rstd
        # dx = gamma*rstd * (g - mean(g) - xhat * mean(g*xhat))
        xc = xl.float() - mean
        dx = (weight * rstd) * (gl.float() - dbeta / n - xc * (rstd * dgamma / n))
        return dx.to(x.dtype).permute(0, 3, 1, 2), dgamma, dbeta, None


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = self.weight * torch.rsqrt(self.running_var + self.eps)
            y = (_nhwc(x).float() - self.running_mean) * mul + self.bias
            return y.to(x.dtype).permute(0, 3, 1, 2)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            m = 1.0 - self.momentum  # flax momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked.add_(1)
        return y
