"""Three times the reference's training forward FLOPs an image times img/s over the chip's peak in the training type (H100 SXM dense: 989 TFLOP/s bf16), in %."""
from s2a_bench.readers import mfu_pct as read  # noqa: F401
