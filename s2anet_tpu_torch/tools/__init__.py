"""The ports of the repository's ``tools/`` scripts, without cv2, jax or
PIL: ``python -m s2anet_tpu_torch.tools.<name>``. Dataset preparation:
``prepare_dota``, ``convert_dota_to_yolo`` and ``convert_hrsc_to_yolo``,
with their flags and their output files. Measurement and inspection:
``profile_report`` (for ``xplane_report.py``), ``quant_scope_bench`` and
``visualize``."""
