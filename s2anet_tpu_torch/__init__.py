"""S2ANet on PyTorch and CUDA (NVIDIA Hopper).

A port of :mod:`s2anet_tpu` (JAX): serving (ResNet + FPN + the S2ANet head,
decode and multiclass rotated NMS; ``predict``, which also tiles and merges
large scenes), the train step (``train``), evaluation on DOTA-format
data (``data``, ``eval``, ``val``), int8 post-training-quantised
serving (``ops/quant.py``, ``val --quant int8``), and the deploy and
measurement tools (``export``: ``torch.export`` over the serving kernels'
custom ops, ``ops/library.py``; ``utils/flops.py``; ``utils/profiler.py``,
whose spans name the layer boundaries in a profiler's trace; ``tools``).
The hot spots run as hand-written CUDA kernels (``csrc/``); the polygon
IoU of the evaluation runs in a small C++ library (``native/``).
Everything else is plain PyTorch and NumPy.

This package imports ``torch`` and ``numpy`` (and PIL, where installed, to
decode an image file); it never imports JAX or the JAX package, so it runs
on a machine that has neither.
"""
