"""Blocking runtime calls a training step inside the program's s2anet.train.step or s2anet.train.feed spans."""
from s2a_bench.spans import train_syncs as read  # noqa: F401
