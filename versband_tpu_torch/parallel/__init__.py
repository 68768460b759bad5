"""Data, tensor and expert parallelism over ``torch.distributed``: the port's
counterpart of ``versband_tpu/parallel/``. ``mesh.py`` lays the ranks out as
a ``(data, model)`` mesh; ``sharding.py`` says which parameters the
``model`` axis splits and slices a module to this rank's part.

One process per card, as Lightning's DDP ran the reference: ``torchrun`` (or
``cli.train --devices N``, which starts the N ranks itself) sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``;
:func:`init_from_env` joins that group, over NCCL on the card and gloo on
the CPU. Each data index loads its own ``batch_size`` from its shard of the
sampler, so the global batch is ``n_data x batch_size``.

The train steps make each rank's gradient the global batch's:
:func:`all_reduce_grads` averages the gradients over a data group once per
micro-step, before the norm, the clip and the optimizer see them;
:func:`global_sum` sums a statistic over the global batch inside the graph
(its backward is again a sum), where a loss is not linear in the batch (the
Band-MoE load-balancing loss). :func:`broadcast_params` starts every rank
from rank 0's weights. Each takes a ``group`` (None: the whole group).

The ``model`` axis needs two autograd ops (Megatron's ``f`` and ``g``):
:func:`copy_to_model` (identity forward, sum over the model group backward)
where a replicated tensor enters a rank's slice of the work, and
:func:`reduce_from_model` (sum forward, identity backward) where the slices'
partial results join. Both are one ``all_reduce``; with ``broadcast`` they are
the only collectives on the model axis, which NCCL serves, and gloo too on
CUDA tensors when the ranks share one card.

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

from versband_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh


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


def init_from_env(device_type: str = "cuda", init_method: Optional[str] = None,
                  backend: Optional[str] = None) -> torch.device:
    """Join the group that ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``MASTER_ADDR``/``MASTER_PORT`` describe (``init_method`` overrides the
    rendezvous, e.g. a ``file://`` path): NCCL with the rank on
    ``cuda:LOCAL_RANK`` for ``device_type`` "cuda", gloo for "cpu".
    ``backend`` overrides the choice: "gloo" on the card lets ranks share one
    card (give them one ``LOCAL_RANK``; NCCL takes one card per rank).
    Returns the rank's device; a second call returns it without joining
    again."""
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --platform cpu to train over gloo")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} needs card {local}, but this host has "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(local)
        device, default = torch.device("cuda", local), "nccl"
    elif device_type == "cpu":
        device, default = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"unsupported device type {device_type!r}; use 'cuda' or 'cpu'")
    if not active():
        dist.init_process_group(backend or default, init_method=init_method or "env://",
                                world_size=int(os.environ["WORLD_SIZE"]),
                                rank=int(os.environ["RANK"]))
    return device


def leave() -> None:
    """Destroy this process's group, where it has one."""
    if active():
        dist.destroy_process_group()


def average_(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Replace each tensor by its mean over the ranks of ``group``, in place:
    one sum all-reduce of one flat buffer per dtype, then a division by the
    group's size. Returns ``tensors``."""
    if not active() or not tensors:
        return tensors
    n = dist.get_world_size(group)
    for flat, parts in _flat_by_dtype(tensors):
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for t, part in zip(parts, flat.split([t.numel() for t in parts])):
            t.copy_(part.view_as(t))
    return tensors


def _flat_by_dtype(tensors: List[torch.Tensor]):
    """(one flat copy, the tensors in it) per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return [(torch.cat([t.reshape(-1) for t in group]), group)
            for group in by_dtype.values()]


def sum_(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Replace each tensor by its sum over the ranks of ``group``, in place
    (one all-reduce per dtype). Returns ``tensors``."""
    if not active() or not tensors:
        return tensors
    for flat, parts in _flat_by_dtype(tensors):
        dist.all_reduce(flat, group=group)
        for t, part in zip(parts, flat.split([t.numel() for t in parts])):
            t.copy_(part.view_as(t))
    return tensors


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor], group=None) -> None:
    """Average the gradients in ``.grad`` over the ranks of ``group``. Every
    parameter must hold one, so that every rank reduces the same buffer."""
    params = list(params)
    if not active():
        return
    if any(p.grad is None for p in params):
        raise ValueError("all_reduce_grads: a parameter has no .grad; every rank must "
                         "reduce the same buffer")
    average_([p.grad for p in params], group)


@torch.no_grad()
def broadcast_params(module: nn.Module, group=None) -> None:
    """Every rank's parameters and buffers set to those of the group's first
    rank (rank 0 for the whole group)."""
    if not active():
        return
    src = 0 if group is None else dist.get_global_rank(group, 0)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable: the
    backward of the sum is the sum of the ranks' gradients."""
    if not active():
        return x
    import torch.distributed.nn.functional as dnn

    return dnn.all_reduce(x, group=group or dist.group.WORLD)


def broadcast_object(obj, group=None):
    """The ``obj`` (picklable) of the group's first rank on every rank."""
    if not active():
        return obj
    src = 0 if group is None else dist.get_global_rank(group, 0)
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def mean_metrics(metrics: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over the ranks of ``group`` (one all-reduce),
    so that a logged loss is the global batch's mean."""
    if not active() or not metrics:
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    average_([stacked], group)
    return {k: stacked[i] for i, k in enumerate(keys)}


# counts of the model axis's all-reduces (forward and backward) and their bytes
MODEL_REDUCES = 0
MODEL_REDUCE_BYTES = 0


def _model_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    global MODEL_REDUCES, MODEL_REDUCE_BYTES
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    MODEL_REDUCES += 1
    MODEL_REDUCE_BYTES += x.numel() * x.element_size()
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _model_all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _model_all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; in the backward, its gradient summed over ``group``
    (each model rank's slice of the work adds its part). Without a group,
    or with ``group`` None, ``x`` itself."""
    if group is None or not active():
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``group``; its gradient goes
    to each rank as it is. Without a group, or with ``group`` None, ``x``."""
    if group is None or not active():
        return x
    return _ReduceFromModel.apply(x, group)
