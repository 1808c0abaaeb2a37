"""Checkpoints, resume and deploy weights.

Counterpart of ``s2anet_tpu/train/checkpoint.py`` (orbax there): one
``torch.save`` file per checkpoint holding the whole training state -- the
model's and the EMA's ``state_dict``, the optimizer's counts, momentum
buffers and accumulated gradient mean (:meth:`.optim.Optimizer.state_dict`),
the best fitness and the epoch -- read back with
``torch.load(weights_only=True)``, and beside it the ``<name>.meta.json``
sidecar of the JAX package. The deploy file is the EMA ``state_dict`` in
float32, which ``python -m s2anet_tpu_torch.predict --weights`` and
``python -m s2anet_tpu_torch.val --weights`` load as it is.
:func:`increment_path` and :func:`get_latest_run` are the JAX functions.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch


def _abs(path) -> Path:
    return Path(path).expanduser().resolve()


def save_checkpoint(path, model, ema, optimizer, best_fitness: float, epoch: int,
                    metadata: Optional[dict] = None) -> None:
    path = _abs(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": model.state_dict(), "ema": ema.module.state_dict(),
                "optimizer": optimizer.state_dict(),
                "best_fitness": float(best_fitness), "epoch": int(epoch)}, path)
    if metadata is not None:
        (path.parent / (path.name + ".meta.json")).write_text(
            json.dumps(metadata, default=str))


def load_checkpoint(path, model, ema, optimizer) -> dict:
    """Restore a :func:`save_checkpoint` file into ``model``, ``ema`` and
    ``optimizer`` in place; returns ``{"best_fitness", "epoch"}``."""
    ckpt = torch.load(_abs(path), map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"])
    ema.module.load_state_dict(ckpt["ema"])
    optimizer.load_state_dict(ckpt["optimizer"])
    return {"best_fitness": ckpt["best_fitness"], "epoch": ckpt["epoch"]}


def increment_path(path, exist_ok: bool = False) -> str:
    """Auto-increment a run dir: runs/exp -> runs/exp2, exp3, ...; with
    ``exist_ok`` the path is returned as it is."""
    p = Path(path)
    if exist_ok or not p.exists():
        return str(p)
    for n in range(2, 10000):
        cand = p.with_name(f"{p.name}{n}")
        if not cand.exists():
            return str(cand)
    raise RuntimeError(f"no free increment for {path}")


def get_latest_run(search_dir="runs/train") -> str:
    """The newest ``*/weights/last`` under ``search_dir`` ("" if none)."""
    cands = sorted(Path(search_dir).glob("*/weights/last"),
                   key=lambda p: p.stat().st_mtime)
    return str(cands[-1]) if cands else ""


def strip_for_deploy(ema, out_path) -> dict:
    """Write the EMA ``state_dict`` in float32 (integer buffers as they
    are), contiguous, to ``out_path``; returns it."""
    deploy = {k: (v.float() if v.is_floating_point() else v).contiguous().cpu()
              for k, v in ema.module.state_dict().items()}
    path = _abs(out_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(deploy, path)
    return deploy
