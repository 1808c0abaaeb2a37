"""Host ms a training step inside the program's s2anet.train.update span (clip, SGD and the EMA), in the profiled stretch."""
from s2a_bench.spans import train_update_ms as read  # noqa: F401
