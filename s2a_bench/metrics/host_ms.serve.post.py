"""Host ms a serving batch inside the program's s2anet.post span (decode and NMS), in the profiled stretch."""
from s2a_bench.spans import serve_post_ms as read  # noqa: F401
