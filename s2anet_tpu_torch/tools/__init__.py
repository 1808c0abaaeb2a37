"""Dataset preparation without cv2, jax or PIL: ``python -m
s2anet_tpu_torch.tools.<name>`` for ``prepare_dota``,
``convert_dota_to_yolo`` and ``convert_hrsc_to_yolo``, the ports of the
repository's ``tools/`` scripts of the same names, with their flags and
their output files."""
