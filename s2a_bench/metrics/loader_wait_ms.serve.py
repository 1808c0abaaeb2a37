"""Host ms a serving batch inside the program's s2anet.pipeline.wait_loader span (the pipeline's wait for its next batch)."""
from s2a_bench.spans import loader_wait_ms as read  # noqa: F401
