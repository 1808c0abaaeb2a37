"""The reference's FLOPs a chip at the cell's shapes times chips/s over the chip's peak in the serving type (H100 SXM dense: 989 TFLOP/s bf16, 67 TFLOP/s float32 with TF32 off), in %."""
from s2a_bench.readers import mfu_pct as read  # noqa: F401
