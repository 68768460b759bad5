"""The ``(data, model)`` mesh over a ``torch.distributed`` group (port of
``versband_tpu/parallel/mesh.py``).

* ``data``: the batch. Each data index loads its own rows, and the
  gradients are averaged over the ranks of a data group.
* ``model``: tensor parallelism over attention heads and expert parallelism
  over stacked experts, as ``sharding.py``'s rules pick them in the
  backbone (a backbone they pick nothing of runs whole on each rank). The
  ranks of a model group hold slices of one model and see the same rows.

Rank r has data index ``r // n_model`` and model index ``r % n_model``, so a
model row lies on neighbouring ranks, as JAX's mesh keeps ``model`` on
neighbouring ICI links. ``data_group`` joins the ranks of this rank's model
index (a column of the mesh), ``model_group`` those of its data index (a
row). Without a process group, ``make_mesh(1, 1)`` is the trivial mesh of
this process alone: its groups are None, and the collectives of
``versband_tpu_torch.parallel`` return at once. The batch sampler shards by
data index: give it ``n_data`` and ``data_rank`` (``cli.train`` sets them on
the datamodule).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(n_data, n_model)`` mesh. ``data_rank`` and
    ``model_rank`` are -1 on a rank the mesh leaves out."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: Any = None
    model_group: Any = None
    group: Any = None  # every rank of the mesh

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def member(self) -> bool:
        return self.data_rank >= 0


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ``(n_data, n_model)`` mesh over the initialised group;
    ``n_data=None`` uses every rank left, ``world // n_model``. A mesh larger
    than the group raises; one smaller warns and leaves the last ranks out.
    Every rank of the group must call it, in the same order (each row and
    column is a ``dist.new_group``)."""
    active = dist.is_available() and dist.is_initialized()
    n, rank = (dist.get_world_size(), dist.get_rank()) if active else (1, 0)
    if n_model < 1:
        raise ValueError(f"n_model must be at least 1, not {n_model}")
    if n_data is None:
        if n % n_model:
            raise ValueError(f"{n} ranks not divisible by n_model={n_model}")
        n_data = n // n_model
    size = n_data * n_model
    if size > n:
        raise ValueError(f"mesh ({n_data} data x {n_model} model) needs {size} ranks "
                         f"but only {n} are available")
    if size != n:
        warnings.warn(f"mesh ({n_data} x {n_model}) uses only {size} of {n} ranks",
                      stacklevel=2)
    if not active:
        return Mesh(n_data, n_model, 0, 0)
    data_group = model_group = None
    for i in range(n_data):  # rows: one data index, every model index
        g = dist.new_group(list(range(i * n_model, (i + 1) * n_model)))
        if i == rank // n_model:
            model_group = g
    for j in range(n_model):  # columns: one model index, every data index
        g = dist.new_group(list(range(j, size, n_model)))
        if j == rank % n_model:
            data_group = g
    group = dist.new_group(list(range(size))) if size != n else dist.group.WORLD
    if rank >= size:
        return Mesh(n_data, n_model, -1, -1)
    return Mesh(n_data, n_model, rank // n_model, rank % n_model, data_group, model_group,
                group)
