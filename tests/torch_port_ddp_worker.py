"""What each rank of tests/test_torch_port_ddp.py runs (spawned processes;
imports torch and the port only).

``main(rank, world, rendezvous, inputs, out_dir)`` joins a gloo group through
a ``file://`` rendezvous, runs the cases of ``inputs`` (a ``torch.save``d
dict made by the test) on this rank's slice of each global batch, and saves
what it saw to ``out_dir/rank<r>.pt``.
"""

import os

import torch

from versband_tpu_torch import parallel


def _slice(x, rank, world):
    if isinstance(x, list):
        return [_slice(v, rank, world) for v in x]
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _with_grads(state):
    """Wrap ``state.apply_gradients`` to keep the gradients it consumes."""
    seen = {}
    apply = state.apply_gradients

    def spy():
        seen.update({k: p.grad.detach().clone() for k, p in state.named.items()})
        return apply()

    state.apply_gradients = spy
    return seen


def cfm_step(case, rank, world, per_rank_usage=False):
    from versband_tpu_torch.models import dit
    from versband_tpu_torch.models.cfm import CFM
    from versband_tpu_torch.train.state import TrainState, make_adamw
    from versband_tpu_torch.train.step import make_cfm_train_step

    cfm = CFM(**case["cfm_kwargs"], device="cpu")
    cfm.model.load_state_dict(case["dit"])
    cfm.first_stage.load_state_dict(case["vae"])
    state = TrainState(cfm.model, make_adamw(case["lr"], eps=case["eps"], grad_clip=1.0))
    grads = _with_grads(state)
    batch = {k: _slice(v, rank, world) for k, v in case["batch"].items()}
    given = {k: _slice(v, rank, world) for k, v in case["given"].items()}
    given["gumbel"] = iter(given["gumbel"])
    real = dit.global_sum
    if per_rank_usage:  # the load-balancing usage of this rank's batch alone
        dit.global_sum = lambda x, group=None: x
    try:
        metrics = make_cfm_train_step(cfm)(state, batch, given=given)
    finally:
        dit.global_sum = real
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "grads": grads,
            "params": {k: v.detach().clone() for k, v in cfm.model.state_dict().items()}}


def vae_step(case, rank, world):
    from versband_tpu_torch.models.autoencoder import AutoencoderKL
    from versband_tpu_torch.train.gan_losses import VAEGANLoss
    from versband_tpu_torch.train.state import TrainState, make_adam
    from versband_tpu_torch.train.vae_step import make_vae_train_step

    vae = AutoencoderKL(**case["vae_kwargs"])
    vae.load_state_dict(case["vae"])
    loss = VAEGANLoss(**case["loss_kwargs"])
    loss.load_state_dict(case["loss"])
    gen = TrainState(vae, make_adam(case["lr"], eps=case["eps"]))
    disc = TrainState(loss, make_adam(case["lr"], eps=case["eps"]))
    gen.step = case["steps_before"]
    m = make_vae_train_step(vae, loss)(gen, disc, {"image": _slice(case["mel"], rank, world)},
                                       given={"posterior": _slice(case["posterior"], rank,
                                                                  world)})
    return {"metrics": {k: float(v) for k, v in m.items()},
            "gen": {k: v.detach().clone() for k, v in vae.state_dict().items()},
            "disc": {k: v.detach().clone() for k, v in loss.state_dict().items()}}


def sampler_epochs(case):
    from versband_tpu_torch.data.sampler import IndexBatchSampler

    s = IndexBatchSampler(range(case["n"]), case["batch_size"], seed=3)
    out = [list(map(list, s))]
    s.set_epoch(1)
    out.append(list(map(list, s)))
    return {"replicas": s.num_replicas, "rank": s.rank, "epochs": out}


def broadcast(rank):
    """Rank r's module starts at r; after ``broadcast_params`` it holds rank
    0's values."""
    m = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in m.parameters():
            p.fill_(float(rank))
    parallel.broadcast_params(m)
    return [p.detach().clone() for p in m.parameters()]


def main(rank, world, rendezvous, inputs, out_dir):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    parallel.init_from_env("cpu", init_method=f"file://{rendezvous}")
    try:
        cases = torch.load(inputs, weights_only=False)
        out = {"world": parallel.world(), "broadcast": broadcast(rank),
               "sampler": sampler_epochs(cases["sampler"])}
        if "cfm" in cases:
            out["cfm"] = cfm_step(cases["cfm"], rank, world)
            out["cfm_per_rank"] = cfm_step(cases["cfm"], rank, world, per_rank_usage=True)
        if "vae" in cases:
            out["vae"] = vae_step(cases["vae"], rank, world)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        parallel.leave()
