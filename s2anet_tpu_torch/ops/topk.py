"""Top-k in the order of ``jax.lax.top_k``.

``lax.top_k`` returns the values in descending order and, among equal
values, the lower index first. ``torch.topk`` promises no order among ties,
and scores tie often: the ODM logits are bf16, so a score carries at most 8
significant bits. The candidate order sets the greedy NMS order, so a tie
broken the other way keeps other boxes. Every top-k of the port goes
through :func:`top_k`, a stable descending sort: on the H100 it took less
time than a ``topk`` over a unique int64 key of (value, index), the other
exact way (``chip_smoke.py`` times both; PERF.md).
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries along the last
    axis: descending, the lower index first on a tie."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]
