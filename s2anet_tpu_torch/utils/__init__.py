"""Training utilities (callback hooks, metric loggers and ``Profile``, the
training plots over the raster figures of ``figure``) and the measurement
ones: ``flops`` (analytic FLOPs of an exported graph, the card's matmul
peak) and ``profiler`` (Chrome traces, timed ops, stage timers)."""
