"""Stage 1 through the trainers: the port's ``VAETrainer`` against the JAX
package's (CPU, fp32, the JAX suite's tiny widths), and ``cli.train`` on a
tiny stage-1 config.

Golden run: both trainers start from the same VAE and loss-module weights,
train on batches from each package's own ``fixed_len`` datasets over one
manifest (tile, crop and an unreadable file; one batch thread, the same
dataset seed) for 5 steps in two epochs with ``disc_start`` 3 (``disc_factor``
0, 0, 0, 2, 2), and validate after each epoch. The JAX trainer's posterior
draws are recorded as it makes them (each train step draws the same noise in
its three VAE forwards) and handed to the port in order.

Bars: each step's ``aeloss``, ``discloss``, ``d_weight``, ``r1_penalty`` and
``rec_loss`` within 1e-5 relative of JAX's; after 5 steps every generator and
discriminator parameter, the BatchNorm statistics among them, within
0.25 x LR of JAX's (five Adam steps move an element by up to 5 LR; a gradient
that differs by dg in summation order moves it by up to LR dg / eps each
step; see tests/test_torch_port_vae_gan.py), ``logvar`` exactly 0; the last
validation's ``val/rec_loss``, ``val/kl_loss`` and ``val/mse`` within 1e-5
relative. Adam's eps is 1e-3 on both sides, as in the one-step tests.
Measured: losses 1.7e-6 relative at most, parameters 0.070 x LR apart at
most, validation 1.9e-6 relative.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from versband_tpu.data.datamodule import DataLoader as JLoader
from versband_tpu.data.fixed_len import JoinSpecsTrain as JTrain
from versband_tpu.data.fixed_len import JoinSpecsValidation as JVal
from versband_tpu.data.sampler import IndexBatchSampler as JSampler
from versband_tpu.models.autoencoder import AutoencoderKL as JVAE
from versband_tpu.train import gan_losses as jgl
from versband_tpu.train.state import TrainState as JState, make_adam as j_adam
from versband_tpu.train.trainer import VAETrainer as JTrainer
from versband_tpu_torch.cli import train as cli
from versband_tpu_torch.data.datamodule import DataLoader
from versband_tpu_torch.data.fixed_len import JoinSpecsTrain, JoinSpecsValidation
from versband_tpu_torch.data.sampler import IndexBatchSampler
from versband_tpu_torch.train.state import make_adam
from versband_tpu_torch.train.trainer import VAETrainer
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import (VAE_GAN_DD, VAE_GAN_DISC as DISC, jax_loss_vars, port_loss,
                                port_vae, record_normals, to_jax, write_stage1_manifest)

B, STEPS, LR, DISC_START, N_VAL = 2, 5, 1e-3, 3, 4
EPS = 1e-3  # Adam's eps on both sides (see the module doc)


class _Module:
    def __init__(self, train, val):
        self.train, self.val = train, val

    def train_dataloader(self):
        return self.train

    def val_dataloader(self):
        return self.val


def _loaders(train_cls, val_cls, sampler, loader, spec):
    tr, va = train_cls(spec), val_cls(spec)
    train = loader(tr, sampler(list(range(len(tr))), B, num_replicas=1, rank=0, seed=0),
                   num_workers=1, prefetch=1)
    val = loader(va, sampler(list(range(N_VAL)), B, num_replicas=1, rank=0, shuffle=False),
                 num_workers=1, prefetch=1)
    return _Module(train, val)


def test_five_steps_and_validation_match_jax(tmp_path, monkeypatch):
    manifest = write_stage1_manifest(tmp_path / "data", 100 + 3 * B)
    spec = dict(spec_dir_path=manifest, spec_crop_len=40, mel_num=80, seed=7)
    common = dict(max_steps=STEPS, max_epochs=2, time_bucket=16, use_tensorboard=False,
                  log_every_n_steps=10 ** 6, seed=0)
    vae = port_vae(1)
    jvae = JVAE(embed_dim=4, ddconfig=VAE_GAN_DD)
    jl = jgl.VAEGANLoss(disc_start=DISC_START, **DISC)
    jv = jax_loss_vars(jl, np.zeros((B, 80, 48), np.float32), seed=4)
    loss = port_loss(jv, disc_start=DISC_START)
    gen_start = to_jax(vae, "vae")

    # the JAX trainer, its draws recorded
    jtr = JTrainer(jvae, jl, learning_rate=LR, logdir=str(tmp_path / "jax"), **common)
    init = jtr.init_states

    def init_from_port(batch):
        init(batch)  # its VAE init draws a posterior sample the port does not: drop it
        jax.effects_barrier()
        draws.clear()
        jtr.gen_state = JState.create(gen_start, j_adam(LR, eps=EPS))
        jtr.disc_state = JState.create(jv, j_adam(LR, eps=EPS))

    jtr.init_states = init_from_port
    j_metrics, j_val = [], {}
    real_step = jtr.train_step

    def jstep(*a):
        g, d, m = real_step(*a)
        j_metrics.append(jax.device_get(m))
        return g, d, m

    jtr.train_step = jstep
    real_log = jtr.log_metrics
    jtr.log_metrics = lambda m, step, prefix="": (j_val.update(m), real_log(m, step, prefix))
    draws = record_normals(monkeypatch)
    jtr.fit(_loaders(JTrain, JVal, JSampler, JLoader, spec))
    jax.effects_barrier()
    monkeypatch.undo()
    assert jtr.global_step == STEPS

    # the port, fed the recorded draws: three per train step, one per validation batch
    tr = VAETrainer(vae, loss, learning_rate=LR, logdir=str(tmp_path / "port"), **common)
    for state in (tr.gen_state, tr.disc_state):
        state.tx = make_adam(LR, eps=EPS)
        state.optimizer.param_groups[0]["eps"] = EPS
    queue = list(draws)
    metrics, vals = [], []

    def take_step():
        first = queue.pop(0)
        for _ in range(2):
            assert np.array_equal(queue.pop(0), first)
        return torch.from_numpy(first)

    one, ev = tr.train_step, tr.eval_step
    tr.train_step = lambda g, d, b, gen: metrics.append(
        one(g, d, b, gen, given={"posterior": take_step()})) or metrics[-1]
    tr.eval_step = lambda b, gen: ev(b, gen, given={"posterior": torch.from_numpy(queue.pop(0))})
    real_validate = tr._validate
    tr._validate = lambda loader: vals.append(real_validate(loader)) or vals[-1]
    tr.fit(_loaders(JoinSpecsTrain, JoinSpecsValidation, IndexBatchSampler, DataLoader, spec))

    assert queue == [] and tr.global_step == STEPS and len(vals) == 2
    assert [m["disc_factor"] for m in metrics] == [0.0, 0.0, 0.0, 2.0, 2.0]
    for m, jm in zip(metrics, j_metrics):
        for k in ("aeloss", "discloss", "d_weight", "r1_penalty", "rec_loss"):
            assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), (k, m[k], jm[k])
    gap = 0.0
    for sd, ref in ((vae.state_dict(), state_dict_from_jax(jax.device_get(jtr.gen_state.params),
                                                           "vae")),
                    (loss.state_dict(), state_dict_from_jax(
                        jax.device_get(jtr.disc_state.params), "vaegan_loss"))):
        assert set(sd) == set(ref)
        for k, p in sd.items():
            gap = max(gap, float((p - ref[k]).abs().max()))
    assert gap <= 0.25 * LR, gap
    assert loss.logvar.item() == 0.0
    start_mean = np.asarray(jv["batch_stats"]["discriminator"]["norm_1"]["mean"])
    assert float((loss.discriminator.main[3].running_mean.detach() - torch.tensor(
        np.array(start_mean))).abs().max()) > 0.5 * LR
    for k in ("val/rec_loss", "val/mse", "val/kl_loss"):
        assert abs(vals[-1][k] - j_val[k]) <= 1e-5 * abs(j_val[k]), (k, vals[-1][k], j_val[k])


STAGE1_TINY = [
    "data.params.batch_size=4", "data.params.num_workers=2", "data.params.spec_crop_len=40",
    "data.params.spec_len=40", "model.params.embed_dim=4",
    *(f"model.params.ddconfig.{o}" for o in (
        "z_channels=4", "ch=16", "ch_mult=[1, 2]", "num_res_blocks=1", "attn_layers=[]")),
    "model.params.lossconfig.params.disc_start=2",
    "model.params.lossconfig.params.disc_hidden_size=8",
    "model.params.lossconfig.params.disc_num_layers=2",
    "lightning.callbacks.image_logger.params.batch_frequency=2",
    "lightning.callbacks.image_logger.params.max_images=2",
    *(f"lightning.callbacks.image_logger.params.vocoder_cfg.params.{o}" for o in (
        "upsample_initial_channel=16", "upsample_rates=[4, 4]",
        "upsample_kernel_sizes=[8, 8]", "resblock_kernel_sizes=[3]",
        "resblock_dilation_sizes=[[1, 3, 5]]")),
]


def test_cli_trains_stage1_resumes_and_serves_as_first_stage(tmp_path, capsys):
    """``cli.train --base configs/ae_accomp.yaml`` on the CPU at tiny widths:
    4 steps in two epochs (``disc_start`` 2), validation, PNG and wav logs,
    ``last`` as a ``{"gen", "disc", "step"}`` pair; ``-r`` resumes to step 6;
    that ``last.pt`` then loads as ``first_stage_config.params.ckpt_path``
    of stage 2's CLI at tiny widths."""
    manifest = write_stage1_manifest(tmp_path / "data", 100 + 2 * 4)
    run = {}
    argv = ["-b", "configs/ae_accomp.yaml", "-t", "--platform", "cpu", "-l",
            str(tmp_path / "logs"), "--max_steps", "4", "--max_epochs", "2", "-s", "3",
            f"data.params.spec_dir_path={manifest}",
            "lightning.callbacks.image_logger.params.vocoder_cfg.params.ckpt_vocoder=",
            *STAGE1_TINY]
    assert cli.main(argv, run=run) == 0
    out = capsys.readouterr().out
    assert ("Setting learning rate to 1.80e-05 = 1 (accumulate) * 1 (devices) * 4 (bs) * "
            "4.50e-06 (base)") in out
    tr, logdir = run["trainer"], run["logdir"]
    assert isinstance(tr, VAETrainer) and tr.global_step == 4
    assert tr.tx.betas == (0.5, 0.9) and tr.tx.learning_rate == pytest.approx(1.8e-5)
    ckpt = torch.load(os.path.join(logdir, "checkpoints", "last.pt"), weights_only=False)
    assert set(ckpt) == {"gen", "disc", "step"} and ckpt["step"] == 4
    assert ckpt["gen"]["step"] == ckpt["disc"]["step"] == 4
    assert json.load(open(os.path.join(logdir, "checkpoints", "last_step.json")))["step"] == 4
    assert out.count("val/rec_loss=") == 2  # validated after each epoch
    assert os.path.exists(os.path.join(logdir, "checkpoints", "epoch_step_4.pt"))
    pngs = glob.glob(os.path.join(logdir, "images", "train", "*.png"))
    wavs = glob.glob(os.path.join(logdir, "audio", "train", "*.wav"))
    assert len(pngs) == len(wavs) == 2 * 3 * 2  # steps 2 and 4, 3 keys, 2 images
    assert tr.loss.logvar.item() == 0.0

    rerun = {}
    assert cli.main(["-r", logdir, "-t", "--platform", "cpu", "--max_steps", "6", "--no-test"],
                    run=rerun) == 0
    assert "Resumed at step 4" in capsys.readouterr().out
    assert rerun["trainer"].global_step == 6
    assert json.load(open(os.path.join(logdir, "checkpoints", "last_step.json")))["step"] == 6

    # the stage-1 checkpoint as stage 2's first stage
    last = os.path.join(logdir, "checkpoints", "last.pt")
    from versband_tpu_torch.models.cfm import CFM

    first = dict(target="versband_tpu.models.autoencoder.AutoencoderKL",
                 params=dict(embed_dim=4, ddconfig={**VAE_GAN_DD}, ckpt_path=last))
    cfm = CFM(first_stage_config=first, device="cpu",
              unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT",
                               params=dict(in_channels=4, context_dim=16, hidden_size=16,
                                           depth=1, num_heads=2, max_len=64, num_experts=2,
                                           ori_dim=12, multiple_of=8)))
    assert cli.load_first_stage(cfm, last)
    gen = torch.load(last, weights_only=False)["gen"]["model"]
    for k, v in cfm.first_stage.state_dict().items():
        assert torch.equal(v, gen[k]), k


def test_every_target_of_ae_accomp_resolves():
    from versband_tpu_torch.utils.config import get_obj_from_str, load_config

    cfg = load_config("configs/ae_accomp.yaml")
    targets = [cfg.model.target, cfg.model.params.lossconfig.target, cfg.data.target,
               cfg.data.params.train.target, cfg.data.params.validation.target,
               cfg.lightning.callbacks.image_logger.target,
               cfg.lightning.callbacks.image_logger.params.vocoder_cfg.target]
    names = [get_obj_from_str(t).__module__ + "." + get_obj_from_str(t).__name__ for t in targets]
    assert names == ["versband_tpu_torch.models.autoencoder.AutoencoderKL",
                     "versband_tpu_torch.train.gan_losses.VAEGANLoss",
                     "versband_tpu_torch.data.datamodule.SpectrogramDataModule",
                     "versband_tpu_torch.data.fixed_len.JoinSpecsTrain",
                     "versband_tpu_torch.data.fixed_len.JoinSpecsValidation",
                     "versband_tpu_torch.train.callbacks.AudioLogger",
                     "versband_tpu_torch.vocoder.bigvgan.VocoderBigVGAN"]


def test_test_pass_writes_each_reconstruction_as_jax_names_it(tmp_path):
    """``VAETrainer.test`` over a ``fixed_len`` test split: one ``.npy`` per
    item under ``output_imgs/fake_class``, named as the JAX trainer names
    it (the ``_<n>`` suffix of a repeated name dropped), and a finite
    ``test/mse_loss``."""
    from versband_tpu.data.fixed_len import JoinSpecsTest as JTest
    from versband_tpu_torch.data.fixed_len import JoinSpecsTest

    manifest = write_stage1_manifest(tmp_path / "data", 9, corrupt=False)
    spec = dict(spec_dir_path=manifest, spec_crop_len=40, mel_num=80, seed=1)

    class _Test:
        def __init__(self, cls, sampler, loader):
            ds = cls(spec)
            self.loader = loader(ds, sampler(list(range(len(ds))), 4, num_replicas=1, rank=0,
                                             shuffle=False), num_workers=1, prefetch=1)

        def test_dataloader(self):
            return self.loader

    jtr = JTrainer(JVAE(embed_dim=4, ddconfig=VAE_GAN_DD), jgl.VAEGANLoss(**DISC),
                   learning_rate=LR, logdir=str(tmp_path / "jax"), use_tensorboard=False,
                   time_bucket=16)
    jtr.init_states({"image": np.zeros((1, 80, 48), np.float32)})
    jtr.test(_Test(JTest, JSampler, JLoader))
    tr = VAETrainer(port_vae(0), port_loss(jax_loss_vars(jgl.VAEGANLoss(**DISC), np.zeros(
        (1, 80, 48), np.float32))), learning_rate=LR, logdir=str(tmp_path / "port"),
        use_tensorboard=False, time_bucket=16)
    metrics = tr.test(_Test(JoinSpecsTest, IndexBatchSampler, DataLoader))
    got = sorted(os.listdir(tmp_path / "port" / "output_imgs" / "fake_class"))
    want = sorted(os.listdir(tmp_path / "jax" / "output_imgs" / "fake_class"))
    assert got == want and len(got) == 7  # 9 rows over 7 names
    arr = np.load(tmp_path / "port" / "output_imgs" / "fake_class" / got[0])
    assert arr.shape == (80, 48) and np.isfinite(metrics["test/mse_loss"])
