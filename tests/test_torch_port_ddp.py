"""Data parallelism in the port (``versband_tpu_torch.parallel``) over gloo
on the CPU, two spawned ranks with a ``file://`` rendezvous under the test's
own directory (so parallel test workers never share a port).

One spawn (``tests/torch_port_ddp_worker.py``) runs every step case, each
rank on its half of one global batch with its half of the injected draws
(posterior, t, flow noise, Gumbel):

* the CFM step with two experts per group and the load-balancing term
  against JAX's ``make_cfm_train_step`` on the whole batch: losses and
  gradient norm within 5e-4 of their scale (the DiT bar), the averaged
  gradients within 5e-4 of each leaf's scale, the updated parameters within
  5e-2 x LR (one AdamW step moves an element by at most about LR, so an
  absolute bar of 5e-4 could not fail; 5e-2 x LR is the bar of the VAE case
  and of tests/test_torch_port_vae_gan.py); and against the port's
  one-process step on the whole batch within 1e-5 (the parameters within
  1e-2 x LR). A step that takes the experts' usage per rank (``global_sum``
  made the identity) is shown to miss the JAX bar, which the global usage
  meets;
* the VAE-GAN generator and discriminator step (``d_weight`` from the
  averaged gradients at the decoder's last conv) against JAX's step on the
  whole batch: losses and ``d_weight`` within 2e-4 relative (the VAE bar),
  parameters within the one-process test's bar (5e-2 x LR);
* the sampler: the two ranks' batches are disjoint and cover the epoch,
  each of ``batch_size`` items, so the global batch is 2 x ``batch_size``;
* ``broadcast_params`` gives every rank rank 0's weights.

Then ``cli.train --platform cpu --devices 2`` trains 2 steps (the CLI starts
its own two ranks), writes one run directory with one checkpoint, and that
checkpoint resumes in one process.
"""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from versband_tpu.models.cfm import CFM as JCFM
from versband_tpu.models.autoencoder import AutoencoderKL as JVAE
from versband_tpu.train import gan_losses as jgl
from versband_tpu.train.state import TrainState as JState, make_adam as j_adam
from versband_tpu.train.state import make_adamw as j_adamw
from versband_tpu.train.step import make_cfm_train_step as j_cfm_step
from versband_tpu.train.vae_step import make_vae_train_step as j_vae_step
from versband_tpu_torch.cli import train as cli
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.train.state import TrainState, make_adamw
from versband_tpu_torch.train.step import make_cfm_train_step
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import (
    BEATS_V, DIT_TINY, MIDI_V, VAE_GAN_DD, VAE_GAN_DISC, VAE_TINY, Draws, jax_loss_vars,
    perturb_zero_init, port_loss, port_vae, to_jax, write_v2a_manifest)
import torch_port_ddp_worker as worker

WORLD = 2
B = 4  # the global batch: 2 per rank
T_MEL = 16
DIT = {**DIT_TINY, "use_flash": True}
CFM_KW = dict(unet_config={"target": "versband_tpu.models.dit.BandMoeDiT", "params": DIT},
              first_stage_config={"target": "versband_tpu.models.autoencoder.AutoencoderKL",
                                  "params": VAE_TINY},
              mel_dim=4, scale_by_std=False, scale_factor=0.7)
LR, EPS = 1e-4, 1e-3  # as tests/test_torch_port_train_step.py
DIT_TOL = 5e-4
PARAM_TOL = 5e-2  # x LR, on the updated parameters
VAE_LR, VAE_REL, VAE_PARAM_TOL = 1e-3, 2e-4, 5e-2 * 1e-3  # tests/test_torch_port_vae_gan.py


def _cfm_case():
    torch.manual_seed(0)
    cfm = CFM(**CFM_KW, device="cpu")
    perturb_zero_init(cfm.model, 0)
    rng = np.random.RandomState(1)
    T = T_MEL // 2
    batch = {"image": rng.randn(B, 80, T_MEL).astype(np.float32),
             "caption": rng.randn(B, 5, 12).astype(np.float32),
             "midi": rng.randint(0, MIDI_V, (B, 1, T_MEL)).astype(np.int32),
             "beats": rng.randint(0, BEATS_V, (B, 1, T_MEL)).astype(np.int32)}
    draws = {"posterior": rng.randn(B, 4, T).astype(np.float32),
             "t": rng.randint(0, 1000, B).astype(np.int32),
             "noise": rng.randn(B, 4, T).astype(np.float32),
             "gumbel": [rng.gumbel(size=s).astype(np.float32)
                        for s in cfm.model.gumbel_shapes(B, T)]}
    return cfm, batch, draws


def _given(draws):
    return {"posterior": torch.from_numpy(draws["posterior"]),
            "t": torch.from_numpy(draws["t"]).long(),
            "noise": torch.from_numpy(draws["noise"]),
            "gumbel": [torch.from_numpy(g) for g in draws["gumbel"]]}


def _vae_case():
    mel = np.random.RandomState(7).randn(B, 80, 64).astype(np.float32)
    vae = port_vae()
    jl = jgl.VAEGANLoss(disc_start=1, **VAE_GAN_DISC)
    jv = jax_loss_vars(jl, mel)
    return mel, vae, jl, jv


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """What each of the two ranks saw, the JAX references and the port's
    one-process step (computed while the ranks run)."""
    root = tmp_path_factory.mktemp("ddp")
    cfm, batch, draws = _cfm_case()
    mel, vae, jl, jv = _vae_case()
    posterior = np.random.RandomState(8).randn(B, 4, 32).astype(np.float32)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cases = {
        "sampler": {"n": 22, "batch_size": 4},
        "cfm": {"cfm_kwargs": CFM_KW, "dit": cfm.model.state_dict(),
                "vae": cfm.first_stage.state_dict(), "lr": LR, "eps": EPS,
                "batch": tbatch, "given": _given(draws)},
        "vae": {"vae_kwargs": dict(embed_dim=4, ddconfig=VAE_GAN_DD),
                "loss_kwargs": dict(disc_start=1, **VAE_GAN_DISC), "vae": vae.state_dict(),
                "loss": port_loss(jv, disc_start=1).state_dict(), "lr": VAE_LR, "eps": EPS,
                "steps_before": 1, "mel": torch.from_numpy(mel),
                "posterior": torch.from_numpy(posterior)}}
    torch.save(cases, root / "inputs.pt")
    ranks = mp.start_processes(worker.main, args=(WORLD, str(root / "rendezvous"),
                                                  str(root / "inputs.pt"), str(root)),
                               nprocs=WORLD, join=False, start_method="spawn")
    ref = {"jax_cfm": _jax_cfm(cfm, batch, draws),
           "jax_vae": _jax_vae(mel, vae, jl, jv, posterior),
           "one_cfm": _one_process_cfm(cfm, tbatch, draws)}
    while not ranks.join(timeout=300):
        pass
    ref["ranks"] = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ref


def _jax_cfm(cfm, batch, draws):
    mp_ = pytest.MonkeyPatch()
    try:
        params, vae_params = to_jax(cfm.model, "dit"), to_jax(cfm.first_stage, "vae")
        jcfm = JCFM(**CFM_KW)
        cond = {"caption": jnp.asarray(batch["caption"]),
                "acoustic": {"midi": jnp.asarray(batch["midi"]),
                             "beats": jnp.asarray(batch["beats"])}}
        mp_.setattr(jax.random, "normal", Draws([draws["posterior"], draws["noise"]]))
        mp_.setattr(jax.random, "randint", Draws([draws["t"]]))
        mp_.setattr(jax.random, "gumbel", Draws(draws["gumbel"]))
        jstate = JState.create(params, j_adamw(LR, eps=EPS, grad_clip=1.0))
        jstate, metrics = jax.jit(j_cfm_step(jcfm, vae_params))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(2))
    finally:
        mp_.undo()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": state_dict_from_jax(jax.device_get(jstate.params), "dit")}


def _jax_vae(mel, vae, jl, jv, posterior):
    """JAX's step, each of its VAE forwards drawing ``posterior``."""
    mp_ = pytest.MonkeyPatch()
    try:
        jgen = JState.create(to_jax(vae, "vae"), j_adam(VAE_LR, eps=EPS))
        jgen = jgen.replace(step=jnp.asarray(1, jnp.int32))
        jdisc = JState.create(jv, j_adam(VAE_LR, eps=EPS))
        mp_.setattr(jax.random, "normal", lambda key, shape=(), *a, **k: jnp.asarray(
            posterior) if tuple(shape) == posterior.shape else pytest.fail(str(shape)))
        jgen2, jdisc2, jm = jax.jit(j_vae_step(JVAE(embed_dim=4, ddconfig=VAE_GAN_DD), jl))(
            jgen, jdisc, {"image": jnp.asarray(mel)}, jax.random.PRNGKey(11))
    finally:
        mp_.undo()
    return {"metrics": {k: float(v) for k, v in jm.items()},
            "gen": state_dict_from_jax(jax.device_get(jgen2.params), "vae"),
            "disc": state_dict_from_jax(jax.device_get(jdisc2.params), "vaegan_loss")}


def _one_process_cfm(cfm, tbatch, draws):
    model = CFM(**CFM_KW, device="cpu")
    model.model.load_state_dict(cfm.model.state_dict())
    model.first_stage.load_state_dict(cfm.first_stage.state_dict())
    state = TrainState(model.model, make_adamw(LR, eps=EPS, grad_clip=1.0))
    grads = worker._with_grads(state)
    given = _given(draws)
    given["gumbel"] = iter(given["gumbel"])
    metrics = make_cfm_train_step(model)(state, tbatch, given=given)
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "grads": grads,
            "params": {k: v.detach().clone() for k, v in model.model.state_dict().items()}}


def _gaps(got, ref, one):
    """Each check's error over its bar's scale: JAX's losses and gradient
    norm against their size (at least 1) and JAX's updated parameters
    in units of LR; the gradients, which JAX's step does not return,
    against the port's one-process full-batch step (held to ``jax.grad`` by
    tests/test_torch_port_train_step.py) leaf by leaf, against the leaf's
    largest gradient floored at 1e-3 of the largest overall."""
    gaps = {k: abs(got["metrics"][k] - ref["metrics"][k]) / max(1.0, abs(ref["metrics"][k]))
            for k in ("loss", "loss_simple", "lb_loss", "grad_norm")}
    scale = max(float(v.abs().max()) for v in one["grads"].values())
    gaps["grads"] = max(float((got["grads"][k] - g).abs().max())
                        / max(float(g.abs().max()), 1e-3 * scale)
                        for k, g in one["grads"].items())
    gaps["params"] = max(float((got["params"][k] - p).abs().max())
                         for k, p in ref["params"].items()) / LR
    return gaps


@pytest.mark.parametrize("usage", ["global", "per_rank"])
def test_two_rank_cfm_step_is_jaxs_full_batch_step(spawned, usage):
    """Both ranks end with the same weights and metrics; with the usage over
    the global batch they are JAX's full-batch step's. With the usage taken
    per rank, the averaged lb term and its gradient are not, and the step
    misses the bar."""
    key = "cfm" if usage == "global" else "cfm_per_rank"
    r0, r1 = (r[key] for r in spawned["ranks"])
    assert r0["metrics"] == r1["metrics"]
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        assert torch.equal(r0["grads"].get(k, r0["params"][k]),
                           r1["grads"].get(k, r1["params"][k])), k
    gaps = _gaps(r0, spawned["jax_cfm"], spawned["one_cfm"])
    if usage == "global":
        assert gaps["params"] <= PARAM_TOL, gaps
        assert max(v for k, v in gaps.items() if k != "params") <= DIT_TOL, gaps
    else:
        assert max(gaps["lb_loss"], gaps["grads"]) > DIT_TOL, gaps


def test_two_rank_cfm_step_is_the_one_process_step(spawned):
    got, ref = spawned["ranks"][0]["cfm"], spawned["one_cfm"]
    for k, v in ref["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
    scale = max(float(g.abs().max()) for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        assert float((got["grads"][k] - g).abs().max()) <= 1e-5 * scale, k
    for k, p in ref["params"].items():
        assert float((got["params"][k] - p).abs().max()) <= 1e-2 * LR, k


def test_two_rank_vae_gan_step_is_jaxs_full_batch_step(spawned):
    ref = spawned["jax_vae"]
    r0, r1 = (r["vae"] for r in spawned["ranks"])
    assert r0["metrics"] == r1["metrics"]
    assert r0["metrics"]["disc_factor"] == ref["metrics"]["disc_factor"] == 2.0
    for k in ("aeloss", "discloss", "d_weight", "r1_penalty", "rec_loss", "nll_loss",
              "kl_loss", "g_loss", "logits_real", "logits_fake"):
        assert abs(r0["metrics"][k] - ref["metrics"][k]) <= VAE_REL * max(
            abs(ref["metrics"][k]), 1e-30), k
    for side in ("gen", "disc"):
        assert set(r0[side]) == set(ref[side])
        for k, p in ref[side].items():
            assert torch.equal(r0[side][k], r1[side][k]), k
            assert float((r0[side][k] - p).abs().max()) <= VAE_PARAM_TOL, (side, k)


def test_ranks_get_disjoint_batches_covering_the_epoch(spawned):
    ranks = [r["sampler"] for r in spawned["ranks"]]
    assert [(s["replicas"], s["rank"]) for s in ranks] == [(2, 0), (2, 1)]
    assert [r["world"] for r in spawned["ranks"]] == [(2, 0), (2, 1)]
    for epoch in (0, 1):
        mine = [s["epochs"][epoch] for s in ranks]
        flat = [i for batches in mine for b in batches for i in b]
        assert sorted(flat) == list(range(22))  # disjoint, and the whole epoch
        assert len(mine[0]) == len(mine[1]) == 3
        # each rank draws batch_size items a step: a global batch of 2 x 4
        assert sorted(len(b) for batches in mine for b in batches) == [2, 4, 4, 4, 4, 4]
    assert ranks[0]["epochs"][0] != ranks[0]["epochs"][1]  # reshuffled per epoch


def test_broadcast_gives_rank_zeros_weights(spawned):
    for r in spawned["ranks"]:
        assert all(float(p.abs().max()) == 0.0 for p in r["broadcast"])


TINY = [
    "data.params.batch_size=4", "data.params.num_workers=0", "data.params.spec_crop_len=64",
    "data.params.min_batch_len=64", "model.params.mel_dim=4",
    *(f"model.params.unet_config.params.{o}" for o in (
        "in_channels=4", "ori_dim=16", "context_dim=16", "hidden_size=16", "num_heads=2",
        "depth=1", "max_len=64", "num_experts=2", "multiple_of=8")),
    *(f"model.params.first_stage_config.params.{o}" for o in (
        "embed_dim=4", "ddconfig.z_channels=4", "ddconfig.ch=8", "ddconfig.ch_mult=[1, 2]",
        "ddconfig.num_res_blocks=1", "ddconfig.attn_layers=[]")),
    "model.params.cond_stage_config.params.max_length=16",
    "model.params.cond_stage_config.params.fallback_config="
    "{d_model: 16, d_ff: 32, d_kv: 8, num_heads: 2, num_layers: 1}",
    "lightning.callbacks.image_logger.params.batch_frequency=1000",
    "lightning.callbacks.image_logger.params.increase_log_steps=false",
    "lightning.callbacks.image_logger.params.vocoder_cfg.params.upsample_initial_channel=16",
]


def test_cli_trains_on_two_ranks_and_resumes_on_one(tmp_path, capfd, monkeypatch):
    manifest, midi = write_v2a_manifest(tmp_path, 316, lengths=(90, 72), seed=0,
                                        vocal_extra=(0, 2))
    logs = tmp_path / "logs"
    over = [f"data.params.main_spec_dir_path={manifest}", f"data.params.other_condition={midi}",
            *TINY]
    argv = ["-b", "configs/vocal2music.yaml", "-t", "-n", "ddp", "-l", str(logs),
            "--platform", "cpu", "--max_steps", "2", "--no-test"]
    assert cli.main(argv + ["--devices", "2", *over]) == 0
    out = capfd.readouterr().out
    assert "Setting learning rate to 2.40e-05 = 1 (accumulate) * 2 (devices) * 4 (bs)" in out
    (logdir,) = glob.glob(str(logs / "*_ddp"))  # both ranks wrote into rank 0's directory
    ckpt = os.path.join(logdir, "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["last.pt", "last_step.json"]
    assert json.loads(open(os.path.join(ckpt, "last_step.json")).read())["step"] == 2
    assert out.count("val/loss_simple=") == 1  # rank 0 alone logs

    run = {}
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # optional; 12 s to import
    assert cli.main(["-r", logdir, "-t", "--platform", "cpu", "--max_steps", "3",
                     "--no-test"], run=run) == 0
    assert "Resumed at step 2" in capfd.readouterr().out
    assert run["trainer"].global_step == 3 and run["trainer"].world == 1


def test_more_cards_than_the_host_has_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"--devices 2 asks for more cards than this host "
                                         r"has \(1\)"):
        cli.main(["-b", "configs/vocal2music.yaml", "-t", "--devices", "2"])
