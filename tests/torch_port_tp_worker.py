"""What each rank of the tensor- and expert-parallel tests runs (spawned
processes; imports torch and the port only).

``main(rank, world, rendezvous, inputs, out_dir)`` joins a gloo group through
a ``file://`` rendezvous, runs the case named by ``inputs``'s ``"kind"`` (a
``torch.save``d dict made by the test) and saves what it saw to
``out_dir/rank<r>.pt``. Every rank makes every mesh, in the same order
(``make_mesh`` is collective); a rank a mesh leaves out skips its work.
"""

import os
import warnings

import torch

from versband_tpu_torch import parallel


def _cfm(case, device="cpu"):
    from versband_tpu_torch.models.cfm import CFM

    cfm = CFM(**case["cfm_kwargs"], device=device)
    cfm.model.load_state_dict(case["dit"])
    cfm.first_stage.load_state_dict(case["vae"])
    return cfm


def _state(cfm, case):
    from versband_tpu_torch.train.state import TrainState, make_adamw

    return TrainState(cfm.model, make_adamw(case["lr"], eps=case["eps"], grad_clip=1.0),
                      ema_decay=case.get("ema"))


def _given(given, place):
    out = dict(place(given))
    if "gumbel" in out:
        out["gumbel"] = iter(out["gumbel"])
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def tp_step(case, n_data, n_model, variant=None):
    """One CFM step at ``(n_data, n_model)``: ``variant`` "per_rank_usage"
    takes the load-balancing usage of this rank's rows alone, "world_usage"
    sums it over every rank, "world_grads" averages the gradients over every
    rank instead of the data group."""
    from versband_tpu_torch.models import dit
    from versband_tpu_torch.parallel.sharding import gather_state_dict
    from versband_tpu_torch.train.state import TrainState
    from versband_tpu_torch.train.step import make_cfm_train_step, shard_train_step

    mesh = parallel.make_mesh(n_data, n_model)
    if not mesh.member:
        return None
    cfm = _cfm(case)
    state = _state(cfm, case)
    step, place_state, place_batch = shard_train_step(make_cfm_train_step(cfm), state,
                                                      case["batch"], mesh)
    state = place_state(state)
    real_sum, real_group = dit.global_sum, TrainState.data_group
    if variant == "per_rank_usage":
        dit.global_sum = lambda x, group=None: x
    elif variant == "world_usage":
        dit.global_sum = lambda x, group=None: real_sum(x)
    elif variant == "world_grads":
        TrainState.data_group = property(lambda s: None)
    before = parallel.MODEL_REDUCES, parallel.MODEL_REDUCE_BYTES
    try:
        metrics = step(state, place_batch(case["batch"]), given=_given(case["given"],
                                                                       place_batch))
    finally:
        dit.global_sum, TrainState.data_group = real_sum, real_group
    reduces = (parallel.MODEL_REDUCES - before[0], parallel.MODEL_REDUCE_BYTES - before[1])
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "params": gather_state_dict(state.model), "reduces": reduces,
            "local_numel": sum(p.numel() for p in state.params), "mesh": mesh.shape,
            "coords": (mesh.data_rank, mesh.model_rank)}


def step_cases(case):
    out = {}
    for n_data, n_model in ((1, 2), (2, 2), (1, 4)):
        out[(n_data, n_model)] = tp_step(case, n_data, n_model)
    for variant in ("per_rank_usage", "world_usage", "world_grads"):
        out[variant] = tp_step(case, 2, 2, variant)
    return out


def rules_cases(case):
    """``shard_module_`` then ``gather_state_dict`` at each layout, what
    each rank holds, the cut model's eval forward (hard routing, dense and
    routed experts) against the whole model's, and ``make_mesh``'s warning
    for a mesh smaller than the group."""
    from versband_tpu_torch.models.dit import BandMoeDiT
    from versband_tpu_torch.parallel.sharding import gather_state_dict, shard_module_

    out = {}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        parallel.make_mesh(1, 2)
    out["warnings"] = [str(w.message) for w in seen]
    for n_data, n_model in ((1, 2), (2, 2), (1, 4)):
        mesh = parallel.make_mesh(n_data, n_model)
        if not mesh.member:
            out[(n_data, n_model)] = None
            continue
        model = BandMoeDiT(**case["dit_kwargs"])
        model.load_state_dict(case["dit"])
        shard_module_(model, mesh)
        out[(n_data, n_model)] = {
            "local": {k: tuple(v.shape) for k, v in model.state_dict().items()},
            "gathered": gather_state_dict(model), "eval": {}}
        for routed in (False, True):
            whole = BandMoeDiT(**case["dit_kwargs"], moe_eval_routed=routed).eval()
            whole.load_state_dict(case["dit"])
            cut = BandMoeDiT(**case["dit_kwargs"], moe_eval_routed=routed).eval()
            cut.load_state_dict(case["dit"])
            shard_module_(cut, mesh)
            with torch.no_grad():
                got = [m(*case["eval_inputs"])[0] for m in (whole, cut)]
            out[(n_data, n_model)]["eval"][routed] = got
    return out


def flash_cases(case):
    """``flash_attention_sharded`` on a (2, 2) mesh: the output, the
    gradients of sum(out^2), and the fallback on an indivisible head count."""
    from versband_tpu_torch.ops.flash_attention import flash_attention_sharded

    mesh = parallel.make_mesh(2, 2)
    out = {}
    q, k, v = (case[n].clone().requires_grad_(True) for n in "qkv")
    o = flash_attention_sharded(q, k, v, case["kv_len"], mesh=mesh)
    (o ** 2).sum().backward()
    out["out"], out["grads"] = o.detach(), [t.grad for t in (q, k, v)]
    before = parallel.MODEL_REDUCES
    out["fallback"] = flash_attention_sharded(*case["odd"], mesh=mesh)
    out["fallback_reduces"] = parallel.MODEL_REDUCES - before
    return out


def card_cases(case):
    """On cuda:0 over gloo (each rank's heads through K1-K3): layer 0's
    ``JointAttention`` and ``BandMoE`` of a small Band-MoE DiT cut at (1, 2)
    against the whole modules in this process, forward and backward, with
    the cut modules' K1/K2/K3 launches; then ``flash_attention_sharded`` at
    (1, 2) and (2, 1) against the plain version on the CPU."""
    from versband_tpu_torch.models.dit import BandMoeDiT
    from versband_tpu_torch.ops import flash_attention as fa
    from versband_tpu_torch.parallel.sharding import shard_module_

    dev = torch.device("cuda")
    mesh = parallel.make_mesh(1, 2)
    whole, cut = (BandMoeDiT(**case["dit_kwargs"]).to(dev) for _ in range(2))
    for m in (whole, cut):
        m.load_state_dict(case["dit"])
    shard_module_(cut, mesh)
    cos, sin = whole.rope_tables(dev)
    x, y, t_emb, caption, acoustic, dout = (case[k].to(dev) for k in (
        "x", "y", "t_emb", "caption", "acoustic", "dout"))
    noise = [n.to(dev) for n in case["noise"]]
    runs = {"attention": lambda m, h: m.layers[0].attention(h, None, cos, sin, y, None),
            "moe": lambda m, h: m.layers[0].feed_forward(h, t_emb, caption, acoustic,
                                                         train=True, noise=noise)[0]}
    out = {}
    for name, run in runs.items():
        res = []
        for m in (whole, cut):
            h = x.clone().requires_grad_(True)
            before = (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
            o = run(m, h)
            o.backward(dout)
            torch.cuda.synchronize()
            res.append((o.detach().cpu(), h.grad.cpu(), tuple(
                b - a for a, b in zip(before, (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)))))
        out[name] = {"whole": res[0], "cut": res[1]}
    for layout in ((1, 2), (2, 1)):
        mesh = parallel.make_mesh(*layout)
        q, k, v = (case[n].to(dev) for n in "qkv")
        before = fa.LAUNCHES
        o = fa.flash_attention_sharded(q, k, v, case["kv_len"].to(dev), mesh=mesh)
        torch.cuda.synchronize()
        out[layout] = (o.cpu(), fa.LAUNCHES - before)
    return out


def _recording_grads(state, seen: list) -> None:
    """Make ``state.apply_gradients`` first record, per call, the gradients
    of the parameters every rank of the model group holds whole (after the
    data group's average, before the clip and AdamW)."""
    apply = state.apply_gradients

    def recording():
        seen.append({k: p.grad.clone() for k, p in state.named.items()
                     if not state.layout.sharded(k)})
        return apply()

    state.apply_gradients = recording


def layout_cases(case, out_dir):
    """The CFM steps of ``case["batches"]`` at each of ``case["layouts"]``,
    from the same weights: each rank's metrics, the gathered weights after
    the first step, the replicated parameters' gradients of the first step
    and what the rank holds. With ``case["resume"]``, rank 0 writes the whole
    state of the first layout after its second step, and the second layout
    resumes it for the third."""
    from versband_tpu_torch.parallel.sharding import gather_state_dict
    from versband_tpu_torch.train.checkpoints import CheckpointManager
    from versband_tpu_torch.train.step import make_cfm_train_step, shard_train_step

    ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"))
    out = {}
    layouts, device = case["layouts"], case.get("device", "cpu")

    def placed(mesh, batch):
        cfm = _cfm(case, device)
        state = _state(cfm, case)
        step, place_state, place_batch = shard_train_step(make_cfm_train_step(cfm), state,
                                                          batch, mesh)
        return step, place_state(state), lambda b: _to(place_batch(b), device)

    for i, layout in enumerate(layouts):
        mesh = parallel.make_mesh(*layout)
        out[layout] = None
        if not mesh.member:
            continue
        step, state, place = placed(mesh, case["batches"][0])
        grads, metrics, params = [], [], None
        _recording_grads(state, grads)
        for j, (batch, given) in enumerate(zip(case["batches"], case["givens"])):
            metrics.append({k: v.item() for k, v in step(
                state, place(batch), given=_given(given, place)).items()})
            if j == 0:
                params = {k: v.cpu() for k, v in gather_state_dict(state.model).items()}
            if j == 1 and i == 0 and case.get("resume"):
                whole = state.state_dict()  # every rank of the row gathers
                if parallel.world()[1] == 0:
                    ckpt.save_last(_Fixed(whole), state.step)
        cut = state.layout
        out[layout] = {"coords": (mesh.data_rank, mesh.model_rank), "metrics": metrics,
                       "params": params, "grads": {k: g.cpu() for k, g in grads[0].items()},
                       "local": {k: tuple(v.shape) for k, v in state.model.state_dict().items()},
                       "slices": sorted(cut.slices), "owned": list(cut.owned),
                       "absent": list(cut.absent),
                       "param_bytes": sum(p.numel() * p.element_size() for p in state.params)}
    dist_barrier()
    if case.get("resume"):
        mesh = parallel.make_mesh(*layouts[1])
        step, state, place = placed(mesh, case["batches"][2])
        assert ckpt.restore_last(state) is not None
        out["resumed_step"] = state.step
        out["resumed_loss"] = step(state, place(case["batches"][2]),
                                   given=_given(case["givens"][2], place))["loss"].item()
    return out


class _Fixed:
    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd


def dist_barrier():
    import torch.distributed as dist

    dist.barrier()


def main(rank, world, rendezvous, inputs, out_dir, device="cpu"):
    """``device`` "cuda": every rank on cuda:0, over gloo."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank if device == "cpu" else 0),
                      WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    parallel.init_from_env(device, init_method=f"file://{rendezvous}", backend="gloo")
    try:
        case = torch.load(inputs, weights_only=False)
        kind = case["kind"]
        if kind == "step":
            out = step_cases(case)
        elif kind == "rules":
            out = rules_cases(case)
        elif kind == "flash":
            out = flash_cases(case)
        elif kind == "card":
            out = card_cases(case)
        elif kind == "layouts":
            out = layout_cases(case, out_dir)
        else:
            raise ValueError(kind)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        parallel.leave()
