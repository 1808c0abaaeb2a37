"""Metric logging: CSV always, TensorBoard when installed, W&B on request.

The port of ``s2anet_tpu/utils/loggers.py``: the same ``results.csv``
(one row per epoch, ``epoch_or_step`` first; when a later row brings new
keys the file is rewritten under the widened header, earlier rows keeping
empty cells), TensorBoard scalars where the ``tensorboard`` package is
installed, and W&B where a project is configured and the ``wandb`` package
is installed. Neither is needed: the machine with the card has neither.
"""

from __future__ import annotations

import csv
import importlib.util
from pathlib import Path
from typing import Dict, Optional

def _installed(name: str) -> bool:
    return importlib.util.find_spec(name) is not None


class Loggers:
    def __init__(self, save_dir, use_wandb: bool = False, wandb_project: str = "s2anet_tpu",
                 wandb_entity: str = "", run_config: Optional[dict] = None):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.save_dir / "results.csv"
        self._csv_keys = None
        self.tb = None
        if _installed("tensorboard"):
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(str(self.save_dir))
        self.wandb = None
        if use_wandb and _installed("wandb"):
            import wandb

            self.wandb = wandb.init(
                project=wandb_project or "s2anet_tpu", entity=wandb_entity or None,
                name=self.save_dir.name, dir=str(self.save_dir), resume="allow",
                config=run_config)

    def log_metrics(self, metrics: Dict[str, float], step: int):
        metrics = {"epoch_or_step": step, **metrics}
        if self._csv_keys is None:
            self._csv_keys = list(metrics.keys())
        new_keys = [k for k in metrics if k not in self._csv_keys]
        if new_keys:
            # the schema grew (val metrics after epoch 0): rewrite the file
            # under the widened header instead of dropping columns
            self._csv_keys = self._csv_keys + new_keys
            if self.csv_path.exists():
                with open(self.csv_path, newline="") as f:
                    rows = list(csv.DictReader(f))
                with open(self.csv_path, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=self._csv_keys, restval="")
                    w.writeheader()
                    w.writerows(rows)
        write_header = not self.csv_path.exists()
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_keys, restval="")
            if write_header:
                w.writeheader()
            w.writerow(metrics)
        if self.tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self.tb.add_scalar(k, v, step)
        if self.wandb is not None:
            self.wandb.log({k: v for k, v in metrics.items()
                            if isinstance(v, (int, float))}, step=step)

    def close(self):
        if self.tb is not None:
            self.tb.flush()
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()
