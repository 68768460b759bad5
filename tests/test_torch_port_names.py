"""Every public name of ``versband_tpu`` has a twin in the port.

The test reads the sources of both packages with ``ast`` (it imports
neither) and takes, per module, the public top-level functions and classes
and the public methods of those classes. Each one of the JAX package must be
defined in the port's file of the same path, in the file :data:`MOVED` names
for it, or be on :data:`ALLOWED` with one of the :data:`REASONS`. Entries of
either table that no longer describe the code fail too, so the tables stay
as short as the gap. The Pallas kernels are private functions of
``versband_tpu/ops/`` (their ports are CUDA C++ in ``ops/csrc``), so the walk
does not take them.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = REPO / "versband_tpu", REPO / "versband_tpu_torch"

# JAX module -> the port module that is its twin, where the paths differ
PORT_FILE = {"utils/torch_convert.py": "utils/convert.py"}

# names the port defines in another module than the JAX package does
MOVED = {
    "cli/generate.py::safe_path": "dsp/audio_io.py",
    "cli/generate.py::write_wav": "dsp/audio_io.py",
    "cli/make_manifest.py::save_df_to_tsv": "utils/tsv.py",
    "text/clap.py::Projection": "text/embedders.py",
    "text/embedders.py::HashTokenizer": "text/tokenizer.py",
    "vocoder/bigvgan.py::kaiser_sinc_filter1d": "ops/fused_act1d.py",
    "vocoder/bigvgan.py::snake": "ops/fused_act1d.py",
}

PLUMBING = "JAX-only plumbing"
ON_PURPOSE = "left out on purpose (ROADMAP.md, 'Left out on purpose')"
TO_JAX = "the torch -> JAX converter half (the port reads the reference's names unchanged)"
REASONS = (PLUMBING, ON_PURPOSE, TO_JAX)

# JAX names with no port twin, each with its reason
ALLOWED = {
    "models/autoencoder.py::AutoencoderKL.setup": (PLUMBING, "flax's setup is __init__"),
    "models/autoencoder2d.py::AutoencoderKL2D.setup": (PLUMBING, "flax's setup is __init__"),
    "models/autoencoder2d.py::VQModel.setup": (PLUMBING, "flax's setup is __init__"),
    "train/gan_losses.py::VAEGANLoss.setup": (PLUMBING, "flax's setup is __init__"),
    "parallel/sharding.py::batch_shardings": (PLUMBING, "NamedSharding trees; the port cuts "
                                              "modules with shard_module_"),
    "parallel/sharding.py::param_shardings": (PLUMBING, "as batch_shardings"),
    "parallel/sharding.py::replicated": (PLUMBING, "as batch_shardings"),
    "text/clap.py::CLAP.ensure_audio_params": (PLUMBING, "flax's lazy init; a torch module "
                                               "holds its weights from construction"),
    "vocoder/bigvgan.py::VocoderBigVGAN.ensure_params": (PLUMBING, "flax's lazy init"),
    "vocoder/hifigan.py::HifiGAN.ensure_params": (PLUMBING, "flax's lazy init"),
    "vocoder/nsf.py::HifiGAN_NSF.ensure_params": (PLUMBING, "flax's lazy init"),
    "vocoder/pwg.py::ParallelWaveGAN.ensure_params": (PLUMBING, "flax's lazy init"),
    "train/trainer.py::VAETrainer.init_states": (PLUMBING, "param and optimizer trees; the "
                                                 "port makes modules and optimizers in __init__"),
    "text/embedders.py::projection_apply": (PLUMBING, "the caption projection applied to a "
                                            "params tree; the port calls its Projection module"),
    "train/state.py::TrainState.create": (PLUMBING, "flax struct constructor"),
    "train/state.py::EmaState.create": (PLUMBING, "flax struct constructor"),
    "vocoder/conv.py::fold_weight_norm": (PLUMBING, "folds a params tree; the port folds "
                                          "modules (fold_weight_norm_, fold_weight_norm_jax)"),
    "vocoder/discriminators.py::NormConv": (PLUMBING, "flax wrapper for weight and spectral "
                                            "norm; the port uses torch's parametrizations"),
    "utils/misc.py::download_checkpoint": (ON_PURPOSE, "downloads only; no network on the card"),
    "utils/misc.py::log_txt_as_img": (ON_PURPOSE, "needs matplotlib; no caller"),
    "utils/tsv.py::copy_file": (ON_PURPOSE, "shell-style file helper, no caller"),
    "utils/tsv.py::link_file": (ON_PURPOSE, "shell-style file helper, no caller"),
    "utils/tsv.py::move_file": (ON_PURPOSE, "shell-style file helper, no caller"),
    "utils/tsv.py::remove_file": (ON_PURPOSE, "shell-style file helper, no caller"),
    "vocoder/bigvgan.py::alias_free_snake_polyphase": (ON_PURPOSE, "TPU polyphase layout"),
    "vocoder/conv.py::polyphase_conv_transpose": (ON_PURPOSE, "TPU MXU trick"),
    "vocoder/conv.py::space_to_depth_conv1d": (ON_PURPOSE, "TPU MXU trick"),
    **{f"utils/torch_convert.py::{n}": (TO_JAX, "reads torch checkpoints into JAX trees")
       for n in ("conv1d_w", "conv2d_w", "convT1d_w", "convert_melgan_state_dict",
                 "convert_state_dict", "fold_torch_batchnorm", "fold_torch_weight_norm",
                 "identity", "linear_w", "load_torch_state_dict")},
}


def public_names(path: Path) -> set:
    """Public top-level functions and classes of ``path``, and ``Class.method``
    for the public methods of its public classes."""
    out = set()
    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{b.name}" for b in node.body
                       if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                       and not b.name.startswith("_"))
    return out


def jax_modules():
    return sorted(str(f.relative_to(JAX_PKG)) for f in JAX_PKG.rglob("*.py"))


def port_names(rel: str) -> set:
    f = PORT_PKG / PORT_FILE.get(rel, rel)
    return public_names(f) if f.exists() else set()


def unmatched() -> dict:
    """``{"module::name": port module or None}`` for every JAX name whose
    twin file does not define it."""
    out = {}
    for rel in jax_modules():
        for name in sorted(public_names(JAX_PKG / rel) - port_names(rel)):
            out[f"{rel}::{name}"] = MOVED.get(f"{rel}::{name}")
    return out


def test_every_public_jax_name_has_a_port_twin():
    gaps = sorted(k for k, moved in unmatched().items() if moved is None and k not in ALLOWED)
    assert not gaps, "public names of versband_tpu with no port twin:\n" + "\n".join(gaps)


@pytest.mark.parametrize("key", sorted(MOVED))
def test_moved_names_live_where_the_table_says(key):
    rel, name = key.split("::")
    assert name in public_names(JAX_PKG / rel), f"{key} is gone from the JAX package"
    assert name not in port_names(rel), f"{key} is in its twin file now: drop it from MOVED"
    assert name in public_names(PORT_PKG / MOVED[key]), f"{name} not in {MOVED[key]}"


def test_allow_list_is_current_and_reasoned():
    gaps = unmatched()
    stale = sorted(k for k in ALLOWED if k not in gaps)
    assert not stale, f"allow-listed names that now have a twin or left JAX: {stale}"
    for key, (reason, why) in ALLOWED.items():
        assert reason in REASONS and why.strip(), key


def test_the_walk_sees_both_packages():
    """The walk reads real modules: the shipped path's names are found on both sides."""
    assert len(jax_modules()) > 60
    for rel, name in [("models/cfm.py", "CFM.sample_cfg"), ("utils/torch_convert.py", "main"),
                      ("ops/flash_attention.py", "flash_attention")]:
        assert name in public_names(JAX_PKG / rel) and name in port_names(rel), (rel, name)
    assert "_attn_kernel" not in public_names(JAX_PKG / "ops/flash_attention.py")
