"""Training utilities (callback hooks, metric loggers, the training plots
over the raster figures of ``figure``) and the measurement ones: ``flops``
(analytic FLOPs of an exported graph, the card's matmul peak) and
``profiler`` (the spans at the layer boundaries, Chrome traces)."""
