"""Host ms inside S2ANetPredictor.predict a batch (the call returns before the device ends), mean over the window."""
from s2a_bench.readers import enqueue_ms as read  # noqa: F401
