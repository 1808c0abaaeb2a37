"""NMS mask and sweep: their bound a batch from the reference's valid candidates (IoU pairs at 67 TFLOP/s float32, bytes at 3.35 TB/s) over their device time, in %."""
from s2a_bench.readers import nms_roofline as read  # noqa: F401
