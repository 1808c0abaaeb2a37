"""Training utilities: callback hooks and metric loggers."""
