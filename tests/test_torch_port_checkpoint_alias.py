"""The port's checkpoint picking and target resolving against the JAX
package (CPU).

* ``get_last_checkpoint`` orders by the step in a file name, never by the
  name: given 90000- and 100000-step files the vocoder wrappers load the
  100000-step weights (the name order would pick 90000).
* Every reference target of the JAX ``TARGET_ALIASES`` resolves in the port
  to a port object of the JAX class's name.
"""

import os

import numpy as np
import pytest
import torch

from versband_tpu.utils import checkpoint as jax_ckpt
from versband_tpu.utils import config as jax_config
from versband_tpu_torch.train.lr_schedules import (LambdaLinearScheduler,
                                                   LambdaWarmUpCosineScheduler)
from versband_tpu_torch.utils import config as port_config
from versband_tpu_torch.utils.checkpoint import get_last_checkpoint
from versband_tpu_torch.vocoder.bigvgan import VocoderBigVGAN
from versband_tpu_torch.vocoder.hifigan import HifiGAN, HifiGanGenerator
from versband_tpu_torch.vocoder.pwg import ParallelWaveGAN, ParallelWaveGANGenerator

HIFI_TINY = dict(upsample_initial_channel=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                 resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),))
PWG_TINY = dict(layers=3, stacks=3, residual_channels=8, gate_channels=16, skip_channels=8,
                aux_channels=20, upsample_scales=(2, 2))
STEPS = (90000, 100000)  # step counts of different digit counts: name order is wrong


def _touch(d, *names):
    for n in names:
        (d / n).write_bytes(b"")


@pytest.mark.parametrize("names", [
    ("model_ckpt_steps_90000.ckpt", "model_ckpt_steps_100000.ckpt"),
    ("model_ckpt_steps_9.npz", "model_ckpt_steps_10.ckpt", "model_ckpt_steps_100.npz"),
    ("model_ckpt_steps_5", "other.ckpt"),
    ("other.ckpt",),
])
def test_last_checkpoint_matches_jax(tmp_path, names):
    _touch(tmp_path, *names)
    d = str(tmp_path)
    assert get_last_checkpoint(d) == jax_ckpt.get_last_checkpoint(d)
    for steps in (9, 10, 90000, 7):
        if steps == 10 and "model_ckpt_steps_10.ckpt" not in names:
            continue
        assert get_last_checkpoint(d, steps) == jax_ckpt.get_last_checkpoint(d, steps)


@pytest.mark.parametrize("kind,names,want", [
    ("hifigan", ("model_ckpt_steps_90000.ckpt", "model_ckpt_steps_100000.ckpt",
                 "model_ckpt_steps_200000.npz"), "model_ckpt_steps_100000.ckpt"),
    ("pwg", ("checkpoint-90000steps.pkl", "checkpoint-100000steps.pkl", "config.yml"),
     "checkpoint-100000steps.pkl"),
    ("bigvgan", ("g_00090000", "g_00100000", "g_latest"), "g_00100000"),
    ("bigvgan", ("g_90000", "g_100000"), "g_100000"),
])
def test_last_checkpoint_takes_the_largest_step(tmp_path, kind, names, want):
    _touch(tmp_path, *names)
    path, d = get_last_checkpoint(str(tmp_path), kind=kind)
    assert os.path.basename(path) == want and d == str(tmp_path)


def test_last_checkpoint_of_one_step(tmp_path):
    _touch(tmp_path, "checkpoint-400steps.pkl", "checkpoint-4000steps.pkl", "g_00000400")
    assert get_last_checkpoint(str(tmp_path), 400, kind="pwg")[0].endswith("-400steps.pkl")
    assert get_last_checkpoint(str(tmp_path), 400, kind="bigvgan")[0].endswith("g_00000400")
    assert get_last_checkpoint(str(tmp_path), 40, kind="pwg") == (None, str(tmp_path))


def _two_checkpoints(tmp_path, make, save):
    """Two generators of distinct random weights saved at 90000 and 100000
    steps; returns the 100000-step generator."""
    gens = []
    for i, step in enumerate(STEPS):
        torch.manual_seed(100 + i)
        gen = make().eval()
        save(gen.state_dict(), step)
        gens.append(gen)
    return gens[1]


def test_hifigan_loads_the_newest_checkpoint(tmp_path):
    cfg = ("upsample_initial_channel: 16\nupsample_rates: [4, 4]\n"
           "upsample_kernel_sizes: [8, 8]\nresblock_kernel_sizes: [3]\n"
           "resblock_dilation_sizes: [[1, 3, 5]]\n")
    (tmp_path / "config.yaml").write_text(cfg)
    newest = _two_checkpoints(
        tmp_path, lambda: HifiGanGenerator(**HIFI_TINY),
        lambda sd, step: torch.save({"state_dict": {"model_gen": sd}},
                                    tmp_path / f"model_ckpt_steps_{step}.ckpt"))
    voc = HifiGAN(str(tmp_path), device="cpu")
    for k, v in newest.state_dict().items():
        assert torch.equal(voc.model.state_dict()[k], v), k
    mel = np.random.RandomState(1).randn(80, 5).astype(np.float32)
    with torch.no_grad():
        ref = newest(torch.from_numpy(mel)[None]).numpy().reshape(-1)
    np.testing.assert_allclose(voc.vocode(mel), ref, atol=1e-6)


def test_pwg_loads_the_newest_checkpoint(tmp_path):
    newest = _two_checkpoints(
        tmp_path, lambda: ParallelWaveGANGenerator(**PWG_TINY),
        lambda sd, step: torch.save({"model": {"generator": sd, "discriminator": {}}},
                                    tmp_path / f"checkpoint-{step}steps.pkl"))
    voc = ParallelWaveGAN(str(tmp_path), device="cpu", **PWG_TINY)
    for k, v in newest.state_dict().items():
        assert torch.equal(voc.model.state_dict()[k], v), k


def test_bigvgan_picks_by_step(tmp_path):
    _touch(tmp_path, "g_90000", "g_100000")
    assert VocoderBigVGAN._find_ckpt(str(tmp_path)).endswith("g_100000")
    (tmp_path / "generator.pt").write_bytes(b"")
    assert VocoderBigVGAN._find_ckpt(str(tmp_path)).endswith("generator.pt")


def test_aliases_are_the_jax_packages():
    assert port_config.TARGET_ALIASES == jax_config.TARGET_ALIASES


@pytest.mark.parametrize("target", sorted(jax_config.TARGET_ALIASES))
def test_every_reference_target_resolves_or_names_its_item(target):
    """Every target resolves to a port object of the JAX class's name (the
    legacy backbones and 2-D autoencoders included: nothing is left to a
    Queue 1 item); the JAX package's name for the same target gives the same
    object."""
    jax_name = jax_config.TARGET_ALIASES[target]
    obj = port_config.get_obj_from_str(target)
    assert obj.__module__.startswith("versband_tpu_torch.")
    assert obj.__name__ == jax_name.rsplit(".", 1)[1]
    assert port_config.get_obj_from_str(jax_name) is obj


@pytest.mark.parametrize("target,params", [
    ("ldm.modules.diffusionmodules.flag_large_dit_moe.VideoFlagLargeDiT",
     dict(in_channels=4, context_dim=12, hidden_size=16, depth=1, num_heads=2, max_len=32,
          num_experts=4, multiple_of=8)),
    ("ldm.modules.diffusionmodules.concatDiT.ConcatOrderDiT2",
     dict(in_channels=4, context_dim=12, hidden_size=32, depth=1, num_heads=2, max_len=64)),
    ("ldm.models.autoencoder.AutoencoderKL",
     dict(embed_dim=3, ddconfig=dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, in_channels=1,
                                     out_ch=1, z_channels=3, resolution=16))),
    ("ldm.models.autoencoder.VQModelInterface",
     dict(embed_dim=3, n_embed=8, ddconfig=dict(ch=32, ch_mult=[1], num_res_blocks=1,
                                                in_channels=1, out_ch=1, z_channels=3))),
    ("ldm.models.autoencoder.IdentityFirstStage", dict(vq_interface=True)),
])
def test_the_legacy_targets_build(target, params):
    """Built from a config as a LatentDiffusion builds its stages: moved and
    put in eval mode."""
    obj = port_config.instantiate_from_config({"target": target, "params": params})
    assert isinstance(obj, torch.nn.Module)
    assert obj.to(torch.float32).eval() is obj
    assert type(obj).__name__ == jax_config.TARGET_ALIASES[target].rsplit(".", 1)[1]


def test_the_ported_targets_build():
    sched = port_config.load_config("configs/vocal2music.yaml").model.params.scheduler_config
    ref = port_config.instantiate_from_config(sched)
    got = port_config.instantiate_from_config(
        {"target": "ldm.lr_scheduler.LambdaLinearScheduler", "params": sched.params})
    assert isinstance(got, LambdaLinearScheduler)
    assert [got(s) for s in (0, 5000, 10000, 20000)] == [ref(s) for s in (0, 5000, 10000, 20000)]
    cos = port_config.instantiate_from_config(
        {"target": "ldm.lr_scheduler.LambdaWarmUpCosineScheduler",
         "params": dict(warm_up_steps=10, lr_min=0.1, lr_max=1.0, lr_start=0.0,
                        max_decay_steps=100)})
    assert isinstance(cos, LambdaWarmUpCosineScheduler) and cos(10) == pytest.approx(1.0)
    voc = port_config.instantiate_from_config(
        {"target": "vocoder.bigvgan.models.VocoderBigVGAN", "params": {"device": "cpu"}})
    assert isinstance(voc, VocoderBigVGAN) and voc.device.type == "cpu"
    ident = port_config.instantiate_from_config({"target": "torch.nn.Identity"})
    x = torch.ones(2)
    assert ident(x) is x


def test_trainer_takes_a_reference_scheduler_target(tmp_path):
    """``CFMTrainer`` builds the schedule of a reference YAML, whose target
    is ``ldm.lr_scheduler.LambdaLinearScheduler``, and follows the JAX one."""
    from versband_tpu.train import lr_schedules as jls
    from versband_tpu_torch.models.cfm import CFM
    from versband_tpu_torch.train.trainer import CFMTrainer

    params = dict(warm_up_steps=[10], cycle_lengths=[10 ** 13], f_start=[1e-6], f_max=[1.0],
                  f_min=[1.0])
    cfm = CFM(device="cpu", scheduler_config=dict(
        target="ldm.lr_scheduler.LambdaLinearScheduler", params=params))
    tr = CFMTrainer(cfm, None, 2.4e-5, logdir=str(tmp_path), use_tensorboard=False)
    want = jls.LambdaLinearScheduler(**params)
    for s in (0, 5, 10, 10 ** 6):
        assert tr.tx.lr_at(s) == float(np.float32(2.4e-5) * np.float32(want(s)))
