"""The CFM train steps (port of ``versband_tpu/train/step.py``:
``make_cfm_train_step`` and ``make_cfm_multi_step``).

One call takes one micro-batch: frozen-VAE encode (posterior sample), t ~
randint(0, 1000), the OT-CFM + load-balance loss in training mode (soft
Gumbel routing), the backward, and ``TrainState.apply_gradients`` (clip,
AdamW, EMA; with accumulation only every k-th call applies). The MoE
annealing schedules see the optimizer step ``state.step // k``, as in JAX.
Randomness comes from a ``torch.Generator`` in the order posterior, t, noise,
Gumbel; any of them can be handed in instead (``given``), which is how the
tests feed the JAX step and this one the same draws.

Under a process group (``versband_tpu_torch.parallel``) each rank's
gradient is averaged over the ranks of its data group right after the
backward, so the norm, the clip and AdamW see the global batch's gradient,
as JAX's global program does; the metrics are averaged too, so the logged
loss is the global batch's. :func:`shard_train_step` puts a step on a
``(data, model)`` mesh: the state's module cut to each rank's slices, the
batch to each data index's rows.

``make_cfm_multi_step`` runs K steps in one call over a ``[K, ...]``-stacked
batch and returns the metrics as ``[K]`` tensors on the device, so a caller
reads them back once per K steps. Its steps take the generator's draws in
the order K single calls would, so its result is theirs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.parallel import mean_metrics
from versband_tpu_torch.parallel.mesh import Mesh
from versband_tpu_torch.parallel.sharding import shard_batch, shard_module_
from versband_tpu_torch.train.state import TrainState
from versband_tpu_torch.utils.profiling import annotate, tag


def _decompress_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Widen wire-compressed inputs (fp16 mels, int16 ids) to compute types."""
    def widen(v):
        if torch.is_tensor(v):
            if v.dtype == torch.float16:
                return v.float()
            if v.dtype == torch.int16:
                return v.int()
        return v

    return {k: widen(v) for k, v in batch.items()}


def make_cfm_train_step(cfm: CFM, accumulate_grad_batches: int = 1
                        ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step_fn(state, batch, generator=None, given=None) -> metrics``.

    ``batch``: {'image': mel [B, 80, T] (encoded by the frozen VAE) or
    'latent': [B, C, T_lat], 'caption': embeddings [B, Ty, E], 'midi' and
    'beats': ids [B, 1, T]}. ``given`` may hold 'posterior' (the VAE's
    standard-normal draw, [B, z, T_lat]), 't' (int [B]), 'noise' ([B, C,
    T_lat]) and 'gumbel' (an iterator of the model's Gumbel draws); what it
    lacks is drawn from ``generator``. Metrics stay on the device: 'loss',
    'loss_simple', 'lb_loss' and 'grad_norm' (of this micro-step's gradient).
    Its spans: ``train.step`` (tagged with ``state.step``) around
    ``train.step.vae_encode``, ``.forward``, ``.backward`` and ``.optimizer``.
    """
    accum = max(1, int(accumulate_grad_batches))

    def step_fn(state: TrainState, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None,
                given: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        with tag(state.step), annotate("train.step"):
            given = given or {}
            batch = _decompress_batch(batch)
            if "image" in batch:
                with annotate("train.step.vae_encode"):
                    x_start = cfm.encode_first_stage(batch["image"], generator,
                                                     noise=given.get("posterior"))
            else:
                x_start = batch["latent"]
            cond = {"caption": batch["caption"],
                    "acoustic": {k: batch[k] for k in ("acoustic", "midi", "beats")
                                 if k in batch}}
            t = given.get("t")
            if t is None:
                t = torch.randint(0, cfm.num_timesteps, (x_start.shape[0],),
                                  generator=generator, device=x_start.device)
            state.optimizer.zero_grad(set_to_none=True)
            with annotate("train.step.forward"):
                loss, metrics = cfm.p_losses(x_start, cond, t, generator,
                                             step=state.step // accum,
                                             noise=given.get("noise"),
                                             gumbel=given.get("gumbel"))
            with annotate("train.step.backward"):
                loss.backward()
            with annotate("train.step.optimizer"):
                state.reduce_gradients()
                metrics = {k: v.detach() for k, v in metrics.items()}
                metrics["grad_norm"] = state.grad_norm(state.grads())
                state.apply_gradients()
            return mean_metrics(metrics, state.data_group)

    return step_fn


def make_cfm_multi_step(cfm: CFM, accumulate_grad_batches: int = 1
                        ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``multi_fn(state, batches, generator=None, given=None) -> metrics``:
    K chained steps of :func:`make_cfm_train_step` over ``batches``, the step
    batch with a leading ``[K]`` axis; ``given`` is None or a list of K
    per-step ``given`` dicts. Metrics come back stacked ``[K]``."""
    step_fn = make_cfm_train_step(cfm, accumulate_grad_batches=accumulate_grad_batches)

    def multi_fn(state: TrainState, batches: Dict[str, Any],
                 generator: Optional[torch.Generator] = None,
                 given: Optional[List[Dict[str, Any]]] = None) -> Dict[str, torch.Tensor]:
        K = next(v.shape[0] for v in batches.values() if torch.is_tensor(v))
        per_step = [step_fn(state, {k: v[i] for k, v in batches.items()}, generator,
                            None if given is None else given[i]) for i in range(K)]
        return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return multi_fn


def shard_train_step(step_fn: Callable[..., Any], state: TrainState, batch_example: Any,
                     mesh: Mesh):
    """A train step over ``mesh`` (JAX ``shard_train_step``): returns
    ``(step, place_state, place_batch)``. ``place_state(state)`` cuts the
    state's module to this rank's slices by ``parallel.sharding``'s rules
    and returns a new state holding this rank's part of ``state`` (its
    weights, moments, EMA and counters, whatever layout they came from);
    ``place_batch(batch)`` takes this data index's rows of a global batch
    (or of injected draws). ``step`` is ``step_fn`` for a placed state."""
    shard_batch(batch_example, mesh)  # a global batch that does not divide raises here

    def place_state(s: TrainState) -> TrainState:
        whole = s.state_dict()
        shard_module_(s.model, mesh)
        placed = TrainState(s.model, s.tx, ema_decay=None if s.ema is None else s.ema.decay)
        placed.load_state_dict(whole)
        return placed

    def place_batch(b: Any) -> Any:
        return shard_batch(b, mesh)

    def step(s: TrainState, *args, **kwargs):
        if s.layout is None or s.layout.mesh is not mesh:
            raise ValueError("the state is not placed on this mesh: call place_state first")
        return step_fn(s, *args, **kwargs)

    return step, place_state, place_batch
