"""Host ms a serving batch inside the program's s2anet.pipeline.wait_device span (a batch's outputs on the host)."""
from s2a_bench.spans import device_wait_ms as read  # noqa: F401
