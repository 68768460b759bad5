"""The port's training CLI and callbacks (CPU, ``--platform cpu``).

``versband_tpu_torch.cli.train.main`` runs ``configs/vocal2music.yaml``
shrunk by the dot overrides of tests/test_cli_e2e.py over a synthetic
manifest: it trains 4 steps in groups of 2 with validation, image and audio
logging, writes ``last`` with ``scale_factor`` and archives the merged
config; ``-r <logdir>`` resumes at step 4 and ends at step 6; the port's
``cli.generate`` then serves the archived config and that checkpoint. Also:
the LR line is the JAX CLI's formula and text, the archived YAML reads (under
``yaml.safe_load``) as the JAX writer's text of the same config, the model
axis (``--n_model``) takes every backbone and raises for ``qk_norm`` before
any rank starts (data parallelism is in tests/test_torch_port_ddp.py), and
the logged PNGs hold
``matplotlib.cm.magma``'s pixels. (Stage 1's CLI runs are in
tests/test_torch_port_vae_gan_trainer.py.)
"""

import glob
import json
import os

import numpy as np
import pytest
import yaml

from versband_tpu_torch.cli import train as cli
from versband_tpu_torch.utils.config import apply_dot_overrides, load_config, resolve_target
from versband_tpu_torch.utils.png import mel_to_rgb, write_png
from torch_port_helpers import write_v2a_manifest

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
    "lightning.callbacks.image_logger.params.batch_frequency=2",
    "lightning.callbacks.image_logger.params.vocoder_cfg.params.upsample_initial_channel=16",
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    manifest, midi = write_v2a_manifest(root, 316, lengths=(90, 72), seed=0,
                                        vocal_extra=(0, 2))
    return dict(root=root, manifest=manifest, midi=midi,
                over=[f"data.params.main_spec_dir_path={manifest}",
                      f"data.params.other_condition={midi}", *TINY])


def _argv(data, logs, *extra):
    return ["-b", "configs/vocal2music.yaml", "-t", "-n", "v2m", "-l", str(logs),
            "--platform", "cpu", *extra, *data["over"]]


def test_train_resume_then_generate(data, tmp_path, capsys):
    from versband_tpu.utils.config import apply_dot_overrides as j_over
    from versband_tpu.utils.config import config_to_yaml as j_to_yaml
    from versband_tpu.utils.config import instantiate_from_config as j_inst
    from versband_tpu.utils.config import load_config as j_load
    from versband_tpu_torch.cli import generate
    from versband_tpu_torch.utils.config import load_config

    logs = tmp_path / "logs"
    run = {}
    assert cli.main(_argv(data, logs, "--max_steps", "4", "--max_epochs", "2",
                          "--steps_per_call", "2", "--prefetch_groups", "1"), run=run) == 0
    out = capsys.readouterr().out
    logdir = run["logdir"]
    tr = run["trainer"]
    assert tr.global_step == 4 and tr.cond_stage is tr.cfm.cond_stage is not None
    ckpt = os.path.join(logdir, "checkpoints")
    meta = json.loads(open(os.path.join(ckpt, "last_step.json")).read())
    assert os.path.exists(os.path.join(ckpt, "last.pt"))
    assert meta["step"] == 4 and meta["scale_factor"] not in (None, 1.0)
    # 16 train rows at batch 4: 4 steps in epoch 0, validated after it
    vals = [float(line.rsplit("=", 1)[1]) for line in out.splitlines()
            if "val/loss_simple=" in line]
    assert len(vals) == 1 and np.isfinite(vals[0])
    assert "Setting learning rate to 1.20e-05 = 1 (accumulate) * 1 (devices) * 4 (bs) * " \
           "3.00e-06 (base)" in out
    assert "First stage: random init (no ckpt_path found)" in out
    for step in (2, 4):
        for name in ("inputs", "samples"):
            for i in range(4):
                assert os.path.exists(f"{logdir}/images/train/{name}_gs-{step:06}_{i:02}.png")
                assert os.path.exists(f"{logdir}/audio/train/{name}_gs-{step:06}_{i:02}.wav")
    png = _pixels(f"{logdir}/images/train/samples_gs-000004_00.png")
    assert png.shape == (80, 128, 3)  # 64-frame crops padded to the 128-frame bucket

    (project,) = glob.glob(os.path.join(logdir, "configs", "*-project.yaml"))
    assert load_config(project) == run["config"] == yaml.safe_load(open(project))
    # the JAX CLI archives its config after its datamodule has injected the
    # shared specs_dataset_cfg into each split, as the port's does
    ref = j_over(j_load("configs/vocal2music.yaml"), data["over"])
    j_inst(ref["data"])
    assert yaml.safe_load(open(project)) == yaml.safe_load(j_to_yaml(ref))
    (lightning,) = glob.glob(os.path.join(logdir, "configs", "*-lightning.yaml"))
    assert load_config(lightning) == run["config"]["lightning"]

    run2 = {}
    assert cli.main(["-r", logdir, "-t", "--platform", "cpu", "--max_steps", "6",
                     "--no-test"], run=run2) == 0
    out = capsys.readouterr().out
    assert "Resumed at step 4" in out and run2["trainer"].global_step == 6
    assert json.loads(open(os.path.join(ckpt, "last_step.json")).read())["step"] == 6
    # the archived configs, re-read; as in JAX, the lightning file (written
    # without a "lightning:" key) also merges its keys in at the top level
    assert {k: run2["config"][k] for k in run["config"]} == run["config"]
    assert set(run2["config"]) - set(run["config"]) == set(run["config"]["lightning"])

    save = tmp_path / "gen"
    assert generate.main(["--config", project, "--ckpt", os.path.join(ckpt, "last.pt"),
                          "--manifest", data["manifest"], "--other_condition", data["midi"],
                          "--scales", "1", "--num_items", "1", "--platform", "cpu",
                          "--save_dir", str(save)]) == 0
    wavs = glob.glob(str(save / "**" / "*.wav"), recursive=True)
    assert len(wavs) == 1
    assert f"Restored scale_factor={run2['trainer'].cfm.scale_factor:.5f}" in \
        capsys.readouterr().out


def test_lr_line_is_the_jax_formula(capsys):
    from types import SimpleNamespace

    for accum, ndev, bs, base, scale in ((1, 1, 8, 3e-6, "true"), (4, 1, 2, 1e-4, "True"),
                                         (2, 1, 8, 4.5e-6, "false")):
        opt = SimpleNamespace(scale_lr=scale, accumulate_grad_batches=accum)
        lr = cli.scaled_lr(opt, ndev, bs, base)
        line = capsys.readouterr().out.strip()
        if scale.lower() == "true":
            want = accum * ndev * bs * base  # versband_tpu/cli/train.py, as written there
            assert lr == want and line == (
                f"Setting learning rate to {want:.2e} = {accum} (accumulate) * {ndev} "
                f"(devices) * {bs} (bs) * {base:.2e} (base)")
        else:
            assert lr == base and line == f"Using base learning rate {base:.2e}"


def unet_override(target: str, **params) -> str:
    """A ``key=value`` override that replaces the whole ``unet_config``."""
    flow = ", ".join(f"{k}: {str(v).lower() if isinstance(v, bool) else v}"
                     for k, v in params.items())
    return f"model.params.unet_config={{target: {target}, params: {{{flow}}}}}"


TIMEFREQ_QK_NORM = unet_override(
    "ldm.modules.diffusionmodules.flag_large_dit_moe.VideoFlagLargeDiT", in_channels=20,
    context_dim=1024, hidden_size=64, num_heads=4, depth=1, num_experts=4, multiple_of=8,
    qk_norm=True)


@pytest.mark.parametrize("args,item", [
    # the model axis of every backbone is ported (tests/test_torch_port_tp_*.py);
    # qk_norm over it is not (its statistics span every head), and raises
    # before any rank starts
    (["-b", "configs/vocal2music.yaml", "-t", "--devices", "2", "--n_model", "2",
      TIMEFREQ_QK_NORM], "qk_norm"),
    (["-b", "configs/vocal2music.yaml", "-t", "--n_model", "2", TIMEFREQ_QK_NORM], "qk_norm"),
])
def test_what_is_not_ported_raises(args, item, tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        cli.main([*args, "-l", str(tmp_path), "--platform", "cpu"])


# the eight backbone classes of the alias table, by a reference target each,
# at small widths (the Band-MoE DiT as the shipped YAML has it)
BACKBONES = {
    "BandMoeDiT": None,
    "TimeFreqMoeDiT": unet_override(
        "ldm.modules.diffusionmodules.flag_large_dit_moe.VideoFlagLargeDiT", in_channels=20,
        context_dim=1024, hidden_size=64, num_heads=4, depth=2, num_experts=4, multiple_of=8),
    **{name: unet_override(f"ldm.modules.diffusionmodules.concatDiT.{name}", in_channels=20,
                           context_dim=1024, hidden_size=64, num_heads=4, depth=2, **extra)
       for name, extra in (("ConcatDiT", {}), ("ConcatDiT2MLP", {}), ("HybridDiT2MLP", {}),
                           ("HybridDiT2MLP2", {"cond_fuse": "concat_proj"}),
                           ("ConcatOrderDiT", {}), ("ConcatOrderDiT2", {}))},
}


@pytest.mark.parametrize("name", list(BACKBONES))
@pytest.mark.parametrize("n_model", [2, 4])
def test_check_model_axis_accepts_every_backbone(name, n_model):
    """``--n_model`` takes every backbone target that JAX's CLI takes (it
    builds the mesh for any ``unet_config``): the check cuts the backbone on
    the meta device and raises nothing."""
    config = load_config("configs/vocal2music.yaml")
    if BACKBONES[name] is not None:
        config = apply_dot_overrides(config, [BACKBONES[name]])
    module = {"BandMoeDiT": "dit", "TimeFreqMoeDiT": "dit_timefreq"}.get(name, "concat_dit")
    target = config["model"]["params"]["unet_config"]["target"]
    assert resolve_target(target) == f"versband_tpu_torch.models.{module}.{name}"
    cli.check_model_axis(config, n_model)


def test_no_base_config_is_an_error(capsys):
    assert cli.main(["-t", "--platform", "cpu"]) == 2


def test_first_stage_loads_from_the_ckpt_path(tmp_path, capsys):
    import torch

    from versband_tpu_torch.models.autoencoder import AutoencoderKL
    from versband_tpu_torch.models.cfm import CFM

    vae = dict(embed_dim=4, ddconfig=dict(double_z=True, in_channels=80, out_ch=80,
                                          z_channels=4, kernel_size=5, ch=8, ch_mult=[1, 2],
                                          num_res_blocks=1, attn_layers=[], down_layers=[0],
                                          dropout=0.0))
    torch.manual_seed(1)
    saved = AutoencoderKL(**vae)
    torch.save(saved.state_dict(), tmp_path / "last.pt")
    cfm = CFM(first_stage_config=dict(target="versband_tpu.models.autoencoder.AutoencoderKL",
                                      params=vae), device="cpu")
    assert cli.load_first_stage(cfm, str(tmp_path / "last.pt"))
    assert "Restored first stage from" in capsys.readouterr().out
    for k, v in saved.state_dict().items():
        assert torch.equal(cfm.first_stage.state_dict()[k], v)
    assert not cli.load_first_stage(cfm, str(tmp_path / "missing"))


def test_png_pixels_are_matplotlibs_magma(tmp_path):
    """The logger's deviation from the JAX package on purpose: one pixel per
    frame and bin (lowest bin at the bottom), not a matplotlib figure; the
    colours are matplotlib's magma, index for index."""
    from matplotlib import cm

    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((80, 37)) * 3 - 2).astype(np.float32)
    mel[0, :4] = [-5.0, 1.5, -100.0, 100.0]  # the ends and beyond them
    path = str(tmp_path / "m.png")
    write_png(path, mel_to_rgb(mel, -5.0, 1.5))
    norm = np.clip((mel.astype(np.float64) + 5.0) / 6.5, 0.0, 1.0)
    want = cm.magma(norm, bytes=True)[::-1, :, :3]
    got = _pixels(path)
    assert got.shape == (80, 37, 3) and np.array_equal(got, want)


def _pixels(path):
    """A PNG's 8-bit RGB, read by matplotlib."""
    import matplotlib.image

    return (matplotlib.image.imread(path)[..., :3] * 255).round().astype(np.uint8)
