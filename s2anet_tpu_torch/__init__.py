"""S2ANet serving on PyTorch and CUDA (NVIDIA Hopper).

A port of the serving path of :mod:`s2anet_tpu` (JAX): ResNet + FPN + the
S2ANet head, decode and multiclass rotated NMS. The two hot spots run as
hand-written CUDA kernels (``csrc/``): the AlignConv forward and the rotated
IoU behind the NMS. Everything else is plain PyTorch.

This package imports ``torch`` and ``numpy`` only; it never imports JAX or
the JAX package, so it runs on a machine that has neither.
"""
