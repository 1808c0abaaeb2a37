"""Evaluation: VOC mAP on rotated polygons and the evaluation runner."""
