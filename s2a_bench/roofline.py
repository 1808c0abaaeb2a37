"""Operations and bytes of the program's hand kernels, from the work a call
must do: the least time of a call is the larger of its bytes over the
HBM rate and its operations over the compute rate (H100 SXM, NVIDIA's
data sheet, dense, at 700 W). Every input byte is counted read once and
every output byte written once, and data-dependent work (the NMS pairs) is
what the given candidates need, so a share reads the same whatever
implements the kernel. The arithmetic is that of ``chip_smoke.py``'s
"bound ms" (PERF.md's kernel table).
"""

from __future__ import annotations

import math

import torch

HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12  # float32 on the CUDA cores (TF32 off)
PEAK_FLOP_S = {"bfloat16": BF16_FLOP_S, "float32": F32_FLOP_S}
ELEM_BYTES = {"bfloat16": 2, "float32": 4}
# float32 operations of one rotated-IoU pair (a division or transcendental
# counted as one): a pair whose bounding circles meet runs two clip passes
# of 4 edges x 4 half-planes; a pair the circle test rejects costs 15
IOU_PAIR_OPS, IOU_REJECT_OPS = 1100, 15


def bound_s(nbytes: float, ops: float, flop_s: float) -> float:
    return max(nbytes / HBM_BYTES_S, ops / flop_s)


def share_pct(bound: float, device_s: float):
    """The roofline share in %, or None where the kernels did not run."""
    if not device_s or device_s <= 0 or bound is None:
        return None
    return 100.0 * bound / device_s


def level_sizes(h: int, w: int, strides) -> list:
    """``(H, W)`` of each pyramid level: the stem, the pool and each stride-2
    conv give ``ceil(n / 2)``; P6 and P7 are stride-2 convs too."""
    out = []
    for s in strides:
        hh, ww = h, w
        for _ in range(int(math.log2(s))):
            hh, ww = -(-hh // 2), -(-ww // 2)
        out.append((hh, ww))
    return out


def align_fwd(b: int, levels, c: int = 256, cout: int = 256, elem: int = 2):
    """``(bytes, ops)`` of the AlignConv forward over the levels: x, the
    float32 (dy, dx) offsets of 9 taps and the weight read, y written."""
    nbytes = ops = 0
    for h, w in levels:
        cells = b * h * w
        nbytes += cells * (elem * c + 18 * 4 + elem * cout) + 9 * c * cout * elem
        ops += 2 * cells * 9 * c * cout
    return nbytes, ops


def align_bwd(b: int, levels, c: int = 256, cout: int = 256, elem: int = 2):
    """``(bytes, ops)`` of the AlignConv backward: x, offsets, weight and the
    output gradient read, dx and the float32 dW written; the products of
    dx and of dW, each as many as the forward's."""
    nbytes = ops = 0
    for h, w in levels:
        cells = b * h * w
        nbytes += cells * (elem * c + 18 * 4 + elem * cout + elem * c) + 9 * c * cout * (elem + 4)
        ops += 4 * cells * 9 * c * cout
    return nbytes, ops


def bn_train_bytes(shapes, elem: int = 2) -> float:
    """Bytes of one training step's BatchNorm kernels over activations of
    ``shapes`` ``[(N, C, H, W)]``: statistics read x; normalise reads x and
    writes y; the gradient sums read dy and x; dx reads dy and x and writes
    dx. The per-channel vectors are negligible and left out."""
    return sum(16 * n * c * h * w for n, c, h, w in shapes) * elem / 2


def bn_shapes(arch: str, b: int, h: int, w: int) -> list:
    """``[(N, C, H, W)]`` of every BatchNorm input of the backbone, from the
    reference's ResNet on the meta device (nothing computed)."""
    from .reference.model import ResNet
    shapes = []
    with torch.device("meta"):
        net = ResNet(arch).eval()
        hooks = [m.register_forward_hook(lambda m, i, o: shapes.append(tuple(i[0].shape)))
                 for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        net(torch.empty(b, 3, h, w))
    for hk in hooks:
        hk.remove()
    return shapes


def nms_work(boxes: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor):
    """``(bytes, ops)`` of the NMS mask and sweep on score-sorted candidates
    ``[B, K]``: every pair j > i of valid candidates with equal labels runs
    the IoU routine (in full where the bounding circles meet); the mask
    reads the candidates and writes the words on and above the diagonal,
    the sweep reads the diagonal words and the valid flags and writes the
    keep flags."""
    b, k = valid.shape
    n = int(valid.sum(1).max()) if valid.numel() else 0
    ops = 0
    for i in range(b):
        vi = valid[i, :n]
        same = ((labels[i, :n, None] == labels[i, None, :n]) & vi[:, None] & vi[None, :]).triu(1)
        bx = boxes[i, :n].double()
        r = 0.5 * torch.sqrt(bx[:, 2] ** 2 + bx[:, 3] ** 2)
        near = torch.cdist(bx[:, :2], bx[:, :2]) <= (r[:, None] + r[None, :])
        full = int((same & near).sum())
        ops += full * IOU_PAIR_OPS + (int(same.sum()) - full) * IOU_REJECT_OPS
    cols = (k + 63) // 64
    words = b * 64 * sum(cols - rb for rb in range(cols))
    mask_bytes = b * k * (5 * 4 + 4 + 1) + 8 * words
    sweep_bytes = 8 * b * k + 2 * b * k
    return mask_bytes + sweep_bytes, ops
