"""Host ms a training step inside the program's s2anet.forward span (within s2anet.train.step), in the profiled stretch."""
from s2a_bench.spans import train_forward_ms as read  # noqa: F401
