"""AlignConv forward over P3-P7: its bound a batch (operations at the serving type's peak, 989 TFLOP/s bf16 or 67 TFLOP/s float32, or bytes at 3.35 TB/s) over its kernels' device time, in %."""
from s2a_bench.readers import align_fwd_roofline as read  # noqa: F401
