"""AlignConv backward over P3-P7: its bound a step (operations at 989 TFLOP/s) over its kernels' device time, in %."""
from s2a_bench.readers import align_bwd_roofline as read  # noqa: F401
