"""Blocking runtime calls a serving batch inside the program's s2anet.predict span."""
from s2a_bench.spans import serve_syncs as read  # noqa: F401
