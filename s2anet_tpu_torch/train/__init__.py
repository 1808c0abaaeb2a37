"""Training: LR schedule, optimizer, EMA and the train step.

``python -m s2anet_tpu_torch.train`` drives the step on synthetic batches
(``train/__main__.py``).
"""
