"""Which parameters the ``model`` axis splits, and a module cut to this
rank's part (port of ``versband_tpu/parallel/sharding.py``).

:data:`PARAM_RULES` are ordered regular expressions over the port's
state_dict names; the first that matches gives the parameter's kind, and a
parameter that none matches is replicated. They pick the parameters that
JAX's rules pick over the flax paths (through the name map of
``versband_tpu_torch/utils/convert.py``):

* ``expert``: the stacked Band-MoE experts
  ``(caption|acoustic|freq)_experts.{e}.w[123].weight`` (of them the
  Time/Freq DiT has the frequency experts; its time experts stay whole, as
  in JAX), split over the expert index (EP): a rank holds ``E / n_model``
  whole experts;
* ``column``: the attention's ``wq/wk/wv(_y)`` and a dense feed-forward's
  ``w1/w3``, split over their output rows (torch's ``[out, in]`` layout;
  JAX's ``P(None, 'model')`` on a ``[in, out]`` kernel);
* ``row``: the attention's ``wo``, the caption cross-attention's
  ``out_proj`` and a dense ``w2``, split over their input columns;
* ``head_rows``: the caption cross-attention's packed ``in_proj_weight``,
  the q, k and v rows of this rank's heads (JAX shards its ``wq/wk/wv``
  kernels apart).

As in JAX (``sharding.py:60-72``), a parameter whose split axis does not
divide by ``n_model`` is replicated. Biases and the per-head ``gate`` stay
replicated, as in JAX; the modules slice them at use, through
``copy_to_model``, so their gradients come back whole. One difference: JAX
checks only that a dimension divides, so ``n_model = 3`` over 8 heads of
96 splits a head. :func:`shard_module_` splits an attention only when its
heads divide by ``n_model``, and otherwise keeps it whole on every rank
(the numbers are the same either way).

:func:`shard_module_` cuts any backbone in place to this rank's slices: the
modules it knows (``JointAttention``, the Band-MoE's ``CaptionCrossAttention``
and ``BandMoE``, the Time/Freq DiT's ``TimeFreqMoE``) lose the heads and
experts of other ranks (the names of the rest stay the one-process names),
and a parameter the rules pick in any other module raises. A backbone whose
parameters no rule picks (the ConcatDiT variants) is cut to nothing and runs
whole on every rank of its model group, as under JAX's rules. The layout is
recorded either way; :func:`gather_state_dict` and :func:`load_whole_` go
between the cut module and the one-process state_dict, so a checkpoint is
whole whatever the layout that wrote it. :func:`shard_batch` takes this data
index's rows (``batch_shardings``).
"""

from __future__ import annotations

import dataclasses
import re
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from versband_tpu_torch import parallel
from versband_tpu_torch.parallel.mesh import Mesh

EXPERT, COLUMN, ROW, HEAD_ROWS = "expert", "column", "row", "head_rows"

PARAM_RULES: List[Tuple[str, str]] = [
    (r"(caption|acoustic|freq)_experts\.\d+\.w[123]\.weight$", EXPERT),
    (r"attention\.w[qkv](_y)?\.weight$", COLUMN),
    (r"cross_attention\.in_proj_weight$", HEAD_ROWS),
    (r"attention\.wo\.weight$", ROW),
    (r"cross_attention\.out_proj\.weight$", ROW),
    (r"feed_forward\.w[13]\.weight$", COLUMN),
    (r"feed_forward\.w2\.weight$", ROW),
]
_EXPERT_INDEX = re.compile(r"^(.*_experts)\.(\d+)\.")


def _rule(name: str) -> Optional[str]:
    for pattern, kind in PARAM_RULES:
        if re.search(pattern, name):
            return kind
    return None


def param_specs(shapes: Dict[str, Sequence[int]], n_model: int) -> Dict[str, Optional[str]]:
    """Each parameter's kind under ``n_model`` (None: replicated), from the
    rules and the divisibility fallback. ``shapes`` maps state_dict names to
    shapes; an expert group's size is the count of its indices there."""
    experts: Dict[str, int] = {}
    for name in shapes:
        m = _EXPERT_INDEX.match(name)
        if m:
            experts[m.group(1)] = max(experts.get(m.group(1), 0), int(m.group(2)) + 1)
    out: Dict[str, Optional[str]] = {}
    for name, shape in shapes.items():
        kind = _rule(name)
        if kind == EXPERT:
            n = experts[_EXPERT_INDEX.match(name).group(1)]
        elif kind in (COLUMN, HEAD_ROWS):
            n = shape[0] // 3 if kind == HEAD_ROWS else shape[0]
        elif kind == ROW:
            n = shape[1]
        else:
            n = 0
        out[name] = kind if kind is not None and n % n_model == 0 else None
    return out


@dataclasses.dataclass
class Layout:
    """How a module sharded by :func:`shard_module_` maps to its one-process
    form: ``whole`` holds every one-process state_dict entry's shape, in
    order; ``slices`` the sliced entries' (dim, index) into the
    whole tensor; ``owned`` this rank's experts and ``absent`` the other
    ranks'; ``params`` the one-process parameter names (``named_parameters``
    order) and whether each trains."""

    mesh: Mesh
    whole: "OrderedDict[str, torch.Size]"
    slices: Dict[str, Tuple[int, torch.Tensor]]
    owned: List[str]
    absent: List[str]
    params: List[Tuple[str, bool]]

    def sharded(self, name: str) -> bool:
        """Whether this rank holds a part of ``name`` that no other rank of
        its model group holds (a slice, or an expert of its own)."""
        return name in self.slices or name in self.owned


def _heads_split(n_heads: int, n_model: int) -> bool:
    return n_model > 1 and n_heads % n_model == 0


def shard_module_(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut ``module`` (any backbone) to this rank's part of ``mesh`` in place,
    and record its :class:`Layout` as ``module.tp_layout``. Before the
    optimizer is made: the parameters keep their identity, only their data
    shrinks. With ``n_model`` 1 nothing is cut, but the Band-MoE's
    load-balancing usage still sums over the data group. A parameter that
    :data:`PARAM_RULES` pick outside the module kinds this function cuts
    raises ``NotImplementedError`` before anything is cut."""
    from versband_tpu_torch.models.dit import BandMoE, CaptionCrossAttention
    from versband_tpu_torch.models.dit_timefreq import TimeFreqMoE
    from versband_tpu_torch.nn.core import JointAttention

    cutters = (JointAttention, CaptionCrossAttention, BandMoE, TimeFreqMoE)
    if getattr(module, "tp_layout", None) is not None:
        raise ValueError("the module is sharded already")
    if not mesh.member:
        raise ValueError("this rank is not in the mesh")
    m, r = mesh.n_model, mesh.model_rank
    group = mesh.model_group if m > 1 else None
    whole = OrderedDict((k, v.shape) for k, v in module.state_dict().items())
    params = [(k, p.requires_grad) for k, p in module.named_parameters()]
    specs = param_specs(whole, m)
    owners = [f"{p}." for p, sub in module.named_modules() if p and isinstance(sub, cutters)]
    for name, kind in specs.items():
        if kind is not None and not name.startswith(tuple(owners)):
            raise NotImplementedError(
                f"the rules pick {name} ({kind}), but no module that shard_module_ cuts "
                f"({', '.join(c.__name__ for c in cutters)}) holds it")
    slices: Dict[str, Tuple[int, torch.Tensor]] = {}
    owned: List[str] = []
    absent: List[str] = []

    def cut(owner: nn.Module, prefix: str, name: str, dim: int, index: torch.Tensor) -> None:
        full = f"{prefix}.{name}"
        if specs.get(full) is None:
            raise AssertionError(f"{full} is cut but its rule keeps it whole")
        p = owner.get_parameter(name)
        index = index.to(p.device)
        p.data = p.data.index_select(dim, index).contiguous()
        slices[full] = (dim, index)

    def keep_experts(owner: nn.Module, prefix: str, groups: Sequence[str]) -> None:
        """This rank's ``E / m`` experts of each group; the others' become
        None entries, so every name stays the one-process name."""
        E = owner.num_experts
        own = range(r * E // m, (r + 1) * E // m)
        for g in groups:
            experts = getattr(owner, g)
            for e in range(E):
                names = [f"{prefix}.{g}.{e}.{k}" for k in experts[e].state_dict()]
                if e in own:
                    owned.extend(names)
                else:
                    absent.extend(names)
                    experts._modules[str(e)] = None
        owner.tp_group = group

    for prefix, sub in module.named_modules():
        if isinstance(sub, JointAttention):
            if not _heads_split(sub.n_heads, m) or sub.n_kv % m:
                continue
            if sub.q_norm is not None:
                raise NotImplementedError(
                    "qk_norm normalises over every head; its statistics are not reduced "
                    "over the model axis, so qk_norm with n_model > 1 is not supported")
            hd, hl, kvl = sub.head_dim, sub.n_heads // m, sub.n_kv // m
            q_rows = torch.arange(r * hl * hd, (r + 1) * hl * hd)
            kv_rows = torch.arange(r * kvl * hd, (r + 1) * kvl * hd)
            cut(sub, prefix, "wq.weight", 0, q_rows)
            for n in ("wk", "wv") + (("wk_y", "wv_y") if sub.y_dim > 0 else ()):
                cut(sub, prefix, f"{n}.weight", 0, kv_rows)
            cut(sub, prefix, "wo.weight", 1, q_rows)
            sub.tp_group, sub.n_local, sub.kv_local, sub.head_offset = group, hl, kvl, r * hl
        elif isinstance(sub, CaptionCrossAttention):
            if not _heads_split(sub.num_heads, m):
                continue
            hd, hl, d = sub.dim // sub.num_heads, sub.num_heads // m, sub.dim
            cols = torch.arange(r * hl * hd, (r + 1) * hl * hd)
            cut(sub, prefix, "in_proj_weight", 0, torch.cat([cols, cols + d, cols + 2 * d]))
            cut(sub, prefix, "out_proj.weight", 1, cols)
            sub.tp_group, sub.n_local, sub.head_offset = group, hl, r * hl
        elif isinstance(sub, BandMoE):
            sub.data_group = mesh.data_group
            if m > 1 and sub.num_experts % m == 0:
                keep_experts(sub, prefix, ("caption_experts", "acoustic_experts",
                                           "freq_experts"))
        elif isinstance(sub, TimeFreqMoE):
            # the time experts stay whole: no rule names them (JAX's neither)
            if m > 1 and sub.num_experts % m == 0:
                keep_experts(sub, prefix, ("freq_experts",))
    module.tp_layout = Layout(mesh, whole, slices, owned, absent, params)
    return module


def _place(layout: Layout, name: str, local: Optional[torch.Tensor],
           like: torch.Tensor) -> torch.Tensor:
    """``local`` (None: another rank's expert) in a zero tensor of the whole
    shape."""
    buf = torch.zeros(layout.whole[name], dtype=like.dtype, device=like.device)
    if local is None:
        return buf
    dim, index = layout.slices[name]
    return buf.index_copy_(dim, index.to(like.device), local)


@torch.no_grad()
def gather(layout: Layout, tensors: Dict[str, Optional[torch.Tensor]]
           ) -> Dict[str, torch.Tensor]:
    """The whole tensors of ``tensors`` (one-process names; a local tensor,
    or None for another rank's expert): the slices and experts put in zero
    tensors of the whole shape and summed over the model group, one
    all-reduce per dtype. Every rank of the model group must call it with
    the same names."""
    out, split = {}, []
    like = next(t for t in tensors.values() if t is not None)
    for name, t in tensors.items():
        if name in layout.slices or t is None:
            out[name] = _place(layout, name, t, like if t is None else t)
            split.append(out[name])
        elif layout.sharded(name):  # this rank's own expert: others add zeros
            out[name] = t.detach().clone()
            split.append(out[name])
        else:
            out[name] = t.detach().clone()
    if layout.mesh.n_model > 1:
        parallel.sum_(split, layout.mesh.model_group)
    return out


def local_part(layout: Layout, name: str, whole: torch.Tensor) -> Optional[torch.Tensor]:
    """This rank's part of the whole tensor ``name`` (None: another rank's
    expert)."""
    if name in layout.absent:
        return None
    if name in layout.slices:
        dim, index = layout.slices[name]
        return whole.index_select(dim, index.to(whole.device))
    return whole


def gather_state_dict(module: nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """The one-process state_dict of a module cut by :func:`shard_module_`
    (every rank of its model group calls it); ``module.state_dict()`` for
    any other module."""
    layout = getattr(module, "tp_layout", None)
    local = module.state_dict()
    if layout is None:
        return local
    got = gather(layout, OrderedDict((k, local.get(k)) for k in layout.whole))
    return OrderedDict((k, got[k]) for k in layout.whole)


def load_whole_(module: nn.Module, sd: Dict[str, torch.Tensor], mesh: Optional[Mesh] = None
                ) -> nn.Module:
    """Load a one-process state_dict into ``module``, cut or not: a module
    cut by :func:`shard_module_` takes its slices of each tensor (``mesh``,
    when given, must be the one it was cut for)."""
    layout = getattr(module, "tp_layout", None)
    if layout is None:
        module.load_state_dict(sd)
        return module
    if mesh is not None and mesh is not layout.mesh:
        raise ValueError("the module was cut for another mesh")
    missing = [k for k in layout.whole if k not in sd]
    if missing:
        raise KeyError(f"the state_dict lacks {missing[:5]}")
    local = {k: local_part(layout, k, sd[k]) for k in module.state_dict()}
    module.load_state_dict(local)
    return module


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This data index's rows of every tensor or array of ``batch`` (nested
    dicts, lists and tuples; scalars and strings as they are). The leading
    axis must divide by ``n_data``."""
    if mesh.n_data == 1:
        return batch

    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and x and hasattr(x[0], "shape"):
            return type(x)(rows(v) for v in x)
        if hasattr(x, "shape") and len(x.shape) >= 1:
            n = x.shape[0]
            if n % mesh.n_data:
                raise ValueError(f"a batch of {n} rows does not divide over "
                                 f"{mesh.n_data} data ranks")
            b = n // mesh.n_data
            return x[mesh.data_rank * b:(mesh.data_rank + 1) * b]
        return x

    return rows(batch)
