"""Device kernels a serving batch in the profiled stretch."""
from s2a_bench.readers import launches as read  # noqa: F401
