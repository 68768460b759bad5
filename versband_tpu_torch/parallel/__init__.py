"""Data parallelism over ``torch.distributed``: the port's counterpart of
``versband_tpu/parallel/mesh.py`` and ``sharding.py`` for the ``data`` axis
only (tensor and expert parallelism, the ``model`` axis, are ROADMAP Queue 1
item 12's later part).

One process per card, as Lightning's DDP ran the reference: ``torchrun`` (or
``cli.train --devices N``, which starts the N ranks itself) sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``;
:func:`init_from_env` joins that group, over NCCL on the card and gloo on
the CPU. Each rank loads its own ``batch_size`` from its shard of the
sampler, so the global batch is ``world x batch_size``.

The train steps make each rank's gradient the global batch's:
:func:`all_reduce_grads` averages the gradients once per micro-step, before
the norm, the clip and the optimizer see them; :func:`global_sum` sums a
statistic over the global batch inside the graph (its backward is again a
sum), where a loss is not linear in the batch (the Band-MoE load-balancing
loss). :func:`broadcast_params` starts every rank from rank 0's weights.

Without an initialised group each function returns at once and changes
nothing; in a group of one it runs its collective, whose result equals its
input.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn


def active() -> bool:
    """Whether this process is in an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(world size, rank); (1, 0) without a group."""
    if active():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def launched() -> bool:
    """Whether the environment describes a rank of a group (``torchrun``)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_from_env(device_type: str = "cuda", init_method: Optional[str] = None
                  ) -> torch.device:
    """Join the group that ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``MASTER_ADDR``/``MASTER_PORT`` describe (``init_method`` overrides the
    rendezvous, e.g. a ``file://`` path): NCCL with the rank on
    ``cuda:LOCAL_RANK`` for ``device_type`` "cuda", gloo for "cpu". Returns
    the rank's device; a second call returns it without joining again."""
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --platform cpu to train over gloo")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} needs card {local}, but this host has "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(local)
        device, backend = torch.device("cuda", local), "nccl"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"unsupported device type {device_type!r}; use 'cuda' or 'cpu'")
    if not active():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=int(os.environ["WORLD_SIZE"]),
                                rank=int(os.environ["RANK"]))
    return device


def leave() -> None:
    """Destroy this process's group, where it has one."""
    if active():
        dist.destroy_process_group()


def average_(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Replace each tensor by its mean over the ranks, in place: one sum
    all-reduce of one flat buffer per dtype, then a division by the world
    size. Returns ``tensors``."""
    if not active() or not tensors:
        return tensors
    n = dist.get_world_size()
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(n)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))
    return tensors


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Average the gradients in ``.grad`` over the ranks. Every parameter
    must hold one, so that every rank reduces the same buffer."""
    params = list(params)
    if not active():
        return
    if any(p.grad is None for p in params):
        raise ValueError("all_reduce_grads: a parameter has no .grad; every rank must "
                         "reduce the same buffer")
    average_([p.grad for p in params])


@torch.no_grad()
def broadcast_params(module: nn.Module) -> None:
    """Every rank's parameters and buffers set to rank 0's."""
    if not active():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the backward of the
    sum is the sum of the ranks' gradients."""
    if not active():
        return x
    import torch.distributed.nn.functional as dnn

    return dnn.all_reduce(x)


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over the ranks (one all-reduce), so that a
    logged loss is the global batch's mean."""
    if not active() or not metrics:
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    average_([stacked])
    return {k: stacked[i] for i, k in enumerate(keys)}
