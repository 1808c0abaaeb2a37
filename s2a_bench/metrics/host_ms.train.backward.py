"""Host ms a training step inside the program's s2anet.train.backward span (zero_grad and backward), in the profiled stretch."""
from s2a_bench.spans import train_backward_ms as read  # noqa: F401
