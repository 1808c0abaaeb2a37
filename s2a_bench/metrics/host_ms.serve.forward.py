"""Host ms a serving batch inside the program's s2anet.forward span, in the profiled stretch."""
from s2a_bench.spans import serve_forward_ms as read  # noqa: F401
