"""Device ms a serving batch of the elementwise kernel group."""
from s2a_bench.readers import elementwise_ms as read  # noqa: F401
