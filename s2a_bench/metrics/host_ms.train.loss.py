"""Host ms a training step inside the program's s2anet.train.loss span (assigner and loss), in the profiled stretch."""
from s2a_bench.spans import train_loss_ms as read  # noqa: F401
