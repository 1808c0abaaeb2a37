"""Share of the profiled training stretch with no kernel or copy on the device, in %."""
from s2a_bench.readers import idle_pct as read  # noqa: F401
