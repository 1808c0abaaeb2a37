#!/usr/bin/env python
"""Carry JAX-trained weights into the PyTorch port: an orbax checkpoint ->
an ``.npz`` that ``s2anet_tpu_torch`` serves.

Reads a checkpoint directory of the JAX trainer, either

* a train state (``weights/last``, ``best``, ``epochN``: written by
  ``s2anet_tpu.train.checkpoint.save_checkpoint``), whose EMA weights are
  taken, or its ``params`` / ``batch_stats`` under ``--no-ema``; or
* a deploy checkpoint (``weights/deploy``: ``strip_for_deploy``, EMA
  weights already),

and writes the variables ``{"params", "batch_stats"}`` with
``s2anet_tpu_torch.models.convert.save_jax_npz``. The two layouts are told
apart by what is on disk: a train state has the ``<dir>.meta.json``
sidecar the trainer writes, or a tree with an ``opt_state``; a deploy
checkpoint holds ``params`` and ``batch_stats`` alone.

The ``.npz`` then goes unchanged to the port's entry points, which fold
BatchNorm themselves::

    python tools/jax_to_torch_weights.py --weights runs/train/exp/weights/last \\
        --config configs/dota_r50.yaml --out r50.npz
    python -m s2anet_tpu_torch.predict --weights r50.npz --source scenes/
    python -m s2anet_tpu_torch.val --weights r50.npz --data-root val/images
    python -m s2anet_tpu_torch.export --weights r50.npz --out s2anet.pt2

This script imports JAX and orbax, which the port never does, so it lives
outside both packages; of the port it uses only ``models/convert.py``.
``--config``, ``--backbone`` and ``--num-classes`` describe the model as
for ``tools/export.py``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TRAIN_STATE_KEYS = {"opt_state", "ema_params"}


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", required=True,
                   help="JAX checkpoint dir: a train state (weights/last, best, epochN) "
                        "or weights/deploy")
    p.add_argument("--config", default="")
    # config-mirroring flags default to None: a --config value stays
    # unless the flag is typed
    p.add_argument("--backbone", default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--no-ema", action="store_true",
                   help="a train state's params/batch_stats, not its EMA")
    p.add_argument("--out", default="weights.npz")
    return p.parse_args(argv)


def checkpoint_kind(path) -> str:
    """``"train_state"`` or ``"deploy"``, from the files on disk."""
    import orbax.checkpoint as ocp

    path = Path(path).expanduser().resolve()
    if (path.parent / (path.name + ".meta.json")).exists():
        return "train_state"
    with ocp.StandardCheckpointer() as ckptr:
        meta = ckptr.metadata(str(path))
    keys = set(getattr(meta, "item_metadata", meta).keys())
    if keys & TRAIN_STATE_KEYS:
        return "train_state"
    if keys == {"params", "batch_stats"}:
        return "deploy"
    raise SystemExit(f"{path}: neither a train state nor a deploy checkpoint "
                     f"(top-level keys {sorted(keys)})")


def load_variables(cfg, weights, use_ema: bool = True):
    """``({"params", "batch_stats"}, kind)`` of the checkpoint at
    ``weights`` for the model of ``cfg`` (a JAX ``Config``)."""
    import jax
    import jax.numpy as jnp

    from s2anet_tpu.models.detector import S2ANet
    from s2anet_tpu.train.checkpoint import load_checkpoint, load_deploy
    from s2anet_tpu.train.optim import build_optimizer
    from s2anet_tpu.train.state import create_train_state

    m = cfg.model
    model = S2ANet(backbone_name=m.backbone, num_classes=m.num_classes,
                   strides=tuple(m.strides), with_orconv=m.with_orconv,
                   align_offset_clamp=m.align_offset_clamp)
    # the restore targets' shapes, traced (nothing is initialised); the
    # parameter shapes do not depend on the image size
    variables = jax.eval_shape(lambda x: model.init(jax.random.PRNGKey(0), x, train=False),
                               jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    target = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    kind = checkpoint_kind(weights)
    if kind == "train_state":
        tx = build_optimizer(lambda _: 0.0, params_example=target["params"])
        state = load_checkpoint(weights, jax.eval_shape(
            lambda v: create_train_state(v["params"], v["batch_stats"], tx), target))
        out = ({"params": state.ema_params, "batch_stats": state.ema_batch_stats} if use_ema
               else {"params": state.params, "batch_stats": state.batch_stats})
    else:
        out = load_deploy(weights, target)
    return jax.device_get(out), kind


def main(argv=None) -> dict:
    opt = parse_opt(argv)
    from s2anet_tpu.utils.config import load_config, prune_overrides
    from s2anet_tpu_torch.models.convert import save_jax_npz

    cfg = load_config(opt.config or None, prune_overrides({
        "model": {"backbone": opt.backbone, "num_classes": opt.num_classes}}))
    variables, kind = load_variables(cfg, opt.weights, use_ema=not opt.no_ema)
    save_jax_npz(opt.out, variables)
    which = "deploy (EMA)" if kind == "deploy" else ("params" if opt.no_ema else "EMA")
    print(f"{opt.weights}: {kind}, {which} weights of {cfg.model.backbone} "
          f"({cfg.model.num_classes} classes) -> {opt.out}")
    return {"kind": kind, "out": opt.out}


if __name__ == "__main__":
    main()
