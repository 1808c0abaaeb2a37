"""Seeded uint8 RGB images, made on the device in a few large calls.

Aerial chips have smooth structure and fine texture; random weights
respond to neither in a way that matters for speed, so an image is a
low-frequency field (a coarse random grid upsampled) plus per-pixel noise.
:func:`letterbox` puts an image of another size onto a square canvas as
the evaluation loader does (aspect kept, grey 114 padding, centred).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def field(n: int, h: int, w: int, gen, device) -> torch.Tensor:
    """``[n, 3, h, w]`` float32 in [0, 255)."""
    low = torch.rand(n, 3, h // 32 + 2, w // 32 + 2, generator=gen, device=device)
    base = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    noise = torch.rand(n, 3, h, w, generator=gen, device=device)
    return base * 200.0 + noise * 55.0


def square_chips(n: int, size: int, gen, device) -> torch.Tensor:
    """``[n, size, size, 3]`` uint8 on ``device``."""
    out = torch.empty(n, size, size, 3, dtype=torch.uint8, device=device)
    for i in range(0, n, 16):
        j = min(n, i + 16)
        out[i:j] = field(j - i, size, size, gen, device).to(torch.uint8).permute(0, 2, 3, 1)
    return out
