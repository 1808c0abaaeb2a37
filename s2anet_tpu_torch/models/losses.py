"""Detection losses, elementwise; masks and reductions are the caller's.

Counterpart of ``s2anet_tpu/models/losses.py``: TF-style sigmoid focal loss
(gamma 2, alpha 0.5 in S2ANet) and smooth L1 (beta 1/9) summed over the 5
box parameters.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy on logits (stable form)."""
    return (torch.clamp_min(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def focal_loss_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                           gamma: float = 2.0, alpha: float = 0.5) -> torch.Tensor:
    """``BCE(x, t) * (t*alpha + (1-t)*(1-alpha)) * (1 - p_t)^gamma`` with
    ``p_t = t*p + (1-t)*(1-p)``, elementwise."""
    bce = bce_with_logits(logits, targets)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1.0 - targets) * (1.0 - p)
    alpha_f = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    return bce * alpha_f * torch.pow(1.0 - p_t, gamma)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0 / 9.0) -> torch.Tensor:
    """Huber per element, summed over the last axis: ``[..., 5] -> [...]``."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return loss.sum(-1)
