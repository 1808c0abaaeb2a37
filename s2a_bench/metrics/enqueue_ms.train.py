"""Host ms of a training step's feed and train_step call, mean over the window."""
from s2a_bench.readers import enqueue_ms as read  # noqa: F401
