"""The process group of data-parallel training and of spatial serving, one
process a rank.

Counterpart of ``s2anet_tpu/parallel/mesh.py``. The JAX package keeps one
replicated state and shards each global batch over a mesh of devices; here
each rank is a process (started by ``torchrun``) holding the whole state,
loading its own slice of every global batch and adding up, over the ranks,
what couples the slices: the BatchNorm sums (``models/bn.py``), the
positive counts of the loss (``models/head.py``), the gradient and the loss
items (:mod:`.step`) and, for int8 calibration, the activation ranges
(``ops/quant.py``). So the ranks compute the single-device math on the
global batch, and a checkpoint written by N ranks is one of the one-process
trainer.

Spatial serving (``parallel/spatial.py``, ``predict --mode spatial``)
splits one image's rows over the ranks instead: :func:`halo_rows` fetches
the neighbours' boundary rows around a convolution, :func:`gather_rows`
puts a map back together whole.

Without a group (``world_size() == 1``) none of this runs: a plain
``python -m s2anet_tpu_torch.train`` is one process on one GPU, with no
collective.

The backend follows from the machine: NCCL when each rank on a host has a
GPU of its own, gloo when ranks share a GPU (or run on the CPU). Only
``all_reduce`` and ``broadcast`` are used, the two collectives both offer
for CUDA tensors; the row exchanges are all-reduces too (:func:`slots`),
one code path for both backends.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# the other ranks wait at a broadcast while rank 0 validates, so the group's
# timeout covers a validation over a whole val split (NCCL's default: 10 min)
TIMEOUT = datetime.timedelta(hours=2)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0 alone validates, logs and writes checkpoints."""
    return rank() == 0


def init_group(device="cuda", init_method: str = "env://", rank: int = None,
               world: int = None) -> torch.device:
    """Join the process group; returns this rank's device: ``cuda:i`` with
    ``i = LOCAL_RANK`` modulo the GPUs (ranks share them when they outnumber
    them), or the CPU. Without ``rank`` and ``world`` they come from the
    environment ``torchrun`` sets, as the rendezvous does."""
    device = torch.device(device)
    env = os.environ
    local_rank = int(env.get("LOCAL_RANK", rank or 0))
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", world or env.get("WORLD_SIZE", 1)))
    if device.type == "cuda":
        gpus = torch.cuda.device_count()
        if gpus == 0:
            raise RuntimeError("data-parallel training on cuda: no CUDA device")
        device = torch.device("cuda", local_rank % gpus)
        torch.cuda.set_device(device)
        own = gpus >= local_ranks
        backend = "nccl" if own else "gloo"
        why = (f"{local_ranks} local ranks on {gpus} GPUs: "
               + ("one GPU each" if own else "ranks share a GPU"))
    else:
        backend, why = "gloo", "CPU"
    kw = {} if rank is None else {"rank": rank, "world_size": world}
    dist.init_process_group(backend, init_method=init_method, timeout=TIMEOUT, **kw)
    if dist.get_rank() == 0:
        print(f"data parallel: {dist.get_world_size()} ranks, backend {backend} ({why})",
              flush=True)
    return device


def maybe_initialize_distributed(enable: bool = None, device="cuda") -> torch.device:
    """Join the group under ``torchrun`` (``WORLD_SIZE`` > 1 in the
    environment), or when asked (``enable``, else ``S2A_MULTIHOST`` set
    truthy: ``--multihost`` of the JAX ``train.py``); returns the device
    this process computes on (``device`` itself without a group). Asked for
    a group without ``torchrun``'s environment, the rendezvous raises."""
    if enable is None:
        enable = os.environ.get("S2A_MULTIHOST", "") not in ("", "0")
    if dist.is_initialized() or not (enable or int(os.environ.get("WORLD_SIZE", 1)) > 1):
        return torch.device(device)
    return init_group(device)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def local_batch(global_batch: int) -> int:
    """This rank's share of a global batch, which must divide over the
    ranks (each loads its own slice of every global batch)."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must divide over {n} processes")
    return global_batch // n


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_min(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return t


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def broadcast_one_to_all(value: float, device) -> float:
    """Rank 0's ``value`` on every rank (float64; JAX
    ``multihost_utils.broadcast_one_to_all``); the other ranks wait here
    for it."""
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.broadcast(t, 0)
    return float(t.item())


def barrier(device) -> None:
    """Every rank reaches this point before any goes on (an all-reduce)."""
    all_reduce_sum(torch.zeros(1, device=device)).item()


def slots(t: torch.Tensor) -> torch.Tensor:
    """``[world, *t.shape]``: every rank's ``t``, in rank order. Each rank
    writes its own slot of a zero buffer and an all-reduce sum fills in the
    others: exact, since x + 0 = x (only the sign of a zero may change)."""
    buf = t.new_zeros((world_size(),) + tuple(t.shape))
    buf[rank()] = t
    return all_reduce_sum(buf)


def gather_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole map from every rank's rows along ``dim`` (equal on every
    rank), the ranks' rows in rank order."""
    return torch.cat(slots(x).unbind(0), dim)


def halo_rows(x: torch.Tensor, top: int, bottom: int, dim: int):
    """``(above, below)``: the previous rank's last ``top`` rows along
    ``dim`` and the next rank's first ``bottom`` rows; zeros past the
    image's first and last rows (rank 0's above, the last rank's below).
    Every rank holds as many rows, at least ``max(top, bottom)``."""
    h = x.shape[dim]
    if max(top, bottom) > h:
        raise ValueError(f"halo of {top} + {bottom} rows from shards of {h}")
    edges = slots(torch.cat([x.narrow(dim, h - top, top), x.narrow(dim, 0, bottom)], dim))
    r, n = rank(), world_size()
    above = (edges[r - 1].narrow(dim, 0, top) if r > 0
             else x.new_zeros(x.shape[:dim] + (top,) + x.shape[dim + 1:]))
    below = (edges[r + 1].narrow(dim, top, bottom) if r < n - 1
             else x.new_zeros(x.shape[:dim] + (bottom,) + x.shape[dim + 1:]))
    return above, below
