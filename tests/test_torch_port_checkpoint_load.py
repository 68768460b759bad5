"""``train/checkpoints.py::load_model_checkpoint`` against the JAX package's.

The port restores a model from its own ``torch.save`` files (a state dict or
a trainer's state), from the JAX package's ``.npz`` exports and from a
reference Lightning ``.ckpt``. For each, the weights it ends with equal,
bit for bit, what JAX ``load_model_checkpoint`` makes of the same tree
(converted back with ``state_dict_from_jax``), with ``ignore_keys`` and a
shape mismatch too. An orbax directory raises with the way out.
"""

import numpy as np
import pytest
import torch

from versband_tpu.train.checkpoints import load_model_checkpoint as jax_load
from versband_tpu.utils.checkpoint import save_npz_params as jax_save_npz
from versband_tpu_torch.models.autoencoder import AutoencoderKL
from versband_tpu_torch.models.dit import BandMoeDiT
from versband_tpu_torch.train.checkpoints import load_model_checkpoint
from versband_tpu_torch.train.state import TrainState, make_adamw
from versband_tpu_torch.utils import checkpoint as port_ckpt
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import DIT_TINY, VAE_TINY, perturb_zero_init, to_jax


def _dit(seed):
    torch.manual_seed(seed)
    m = BandMoeDiT(**DIT_TINY).eval()
    perturb_zero_init(m, seed)
    return m


def _jax_result(target, src_tree, tmp_path, family="dit", ignore=()):
    """JAX ``load_model_checkpoint`` of ``src_tree`` (as an npz) into
    ``target``'s params, as the port's state dict."""
    path = str(tmp_path / "jax_src.npz")
    jax_save_npz(path, src_tree)
    loaded = jax_load(to_jax(target, family), path, ignore_keys=ignore)
    return state_dict_from_jax(jax_load.__globals__["jax"].device_get(loaded), family)


def _assert_state(model, want):
    got = model.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k


def test_state_dict_pt(tmp_path):
    src, dst = _dit(1), _dit(2)
    want = _jax_result(dst, to_jax(src, "dit"), tmp_path)
    torch.save(src.state_dict(), tmp_path / "dit.pt")
    _assert_state(load_model_checkpoint(dst, str(tmp_path / "dit.pt")), want)
    _assert_state(dst, src.state_dict())


def test_trainer_state_pt(tmp_path):
    src, dst = _dit(1), _dit(2)
    state = TrainState(src, make_adamw(1e-4))
    torch.save(state.state_dict(), tmp_path / "last.pt")
    want = _jax_result(dst, to_jax(src, "dit"), tmp_path)
    _assert_state(load_model_checkpoint(dst, str(tmp_path / "last.pt")), want)


def test_jax_npz(tmp_path):
    src, dst = _dit(1), _dit(2)
    jax_save_npz(str(tmp_path / "dit.npz"), to_jax(src, "dit"))  # the JAX package's writer
    want = _jax_result(dst, to_jax(src, "dit"), tmp_path)
    _assert_state(load_model_checkpoint(dst, str(tmp_path / "dit.npz")), want)
    # the port's own npz reader reads the JAX writer's files
    flat = port_ckpt.flatten_params(port_ckpt.load_npz_params(str(tmp_path / "dit.npz")))
    ref = port_ckpt.flatten_params(to_jax(src, "dit"))
    assert flat.keys() == ref.keys() and all(np.array_equal(flat[k], ref[k]) for k in flat)


def test_jax_npz_of_a_vae(tmp_path):
    torch.manual_seed(3)
    src = AutoencoderKL(**VAE_TINY).eval()
    torch.manual_seed(4)
    dst = AutoencoderKL(**VAE_TINY).eval()
    port_ckpt.save_npz_params(str(tmp_path / "vae.npz"), to_jax(src, "vae"))
    want = _jax_result(dst, to_jax(src, "vae"), tmp_path, family="vae")
    _assert_state(load_model_checkpoint(dst, str(tmp_path / "vae.npz")), want)


def test_reference_lightning_ckpt(tmp_path):
    """One Lightning checkpoint holds the DiT under ``model.diffusion_model.``
    and the VAE under ``first_stage_model.``; each loads its own part."""
    src = _dit(1)
    torch.manual_seed(3)
    vae_src = AutoencoderKL(**VAE_TINY).eval()
    sd = {**{f"model.diffusion_model.{k}": v for k, v in src.state_dict().items()},
          **{f"first_stage_model.{k}": v for k, v in vae_src.state_dict().items()},
          "cond_stage_model.transformer.shared.weight": torch.zeros(3, 2)}
    torch.save({"state_dict": sd, "global_step": 7, "epoch": 1}, tmp_path / "ref.ckpt")
    dst = _dit(2)
    want = _jax_result(dst, to_jax(src, "dit"), tmp_path)
    _assert_state(load_model_checkpoint(dst, str(tmp_path / "ref.ckpt")), want)
    torch.manual_seed(4)
    vae = AutoencoderKL(**VAE_TINY).eval()
    _assert_state(load_model_checkpoint(vae, str(tmp_path / "ref.ckpt")), vae_src.state_dict())


def test_ignore_keys(tmp_path, capsys):
    src, dst = _dit(1), _dit(2)
    want = _jax_result(dst, to_jax(src, "dit"), tmp_path, ignore=("params/final_layer",))
    torch.save(src.state_dict(), tmp_path / "dit.pt")
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    _assert_state(load_model_checkpoint(dst, str(tmp_path / "dit.pt"),
                                        ignore_keys=("final_layer",)), want)
    assert "Deleting key final_layer" in capsys.readouterr().out
    for k, v in dst.state_dict().items():
        assert torch.equal(v, before[k] if k.startswith("final_layer") else src.state_dict()[k]), k


def test_shape_mismatch_keeps_the_model_init(tmp_path, capsys):
    src, dst = _dit(1), _dit(2)
    tree = to_jax(src, "dit")
    kernel = tree["params"]["final_layer"]["linear"]["kernel"]
    tree["params"]["final_layer"]["linear"]["kernel"] = np.concatenate([kernel, kernel], 0)
    want = _jax_result(dst, tree, tmp_path)
    port_ckpt.save_npz_params(str(tmp_path / "bad.npz"), tree)
    before = dst.state_dict()["final_layer.linear.weight"].clone()
    _assert_state(load_model_checkpoint(dst, str(tmp_path / "bad.npz")), want)
    assert torch.equal(dst.state_dict()["final_layer.linear.weight"], before)
    assert "| shape mismatch at final_layer.linear.weight" in capsys.readouterr().out


def test_only_model_key(tmp_path):
    src, dst = _dit(1), _dit(2)
    torch.save(src.state_dict(), tmp_path / "dit.pt")
    before = dst.state_dict()
    load_model_checkpoint(dst, str(tmp_path / "dit.pt"), only_model_key="final_layer")
    for k, v in dst.state_dict().items():
        ref = src.state_dict()[k] if k.startswith("final_layer.") else before[k]
        assert torch.equal(v, ref), k


def test_an_orbax_directory_raises(tmp_path):
    (tmp_path / "last").mkdir()
    with pytest.raises(ValueError, match="save_npz_params"):
        load_model_checkpoint(_dit(1), str(tmp_path / "last"))


def test_a_checkpoint_that_matches_nothing_raises(tmp_path):
    torch.save({"unrelated.weight": torch.zeros(2)}, tmp_path / "x.pt")
    with pytest.raises(ValueError, match="no weight"):
        load_model_checkpoint(_dit(1), str(tmp_path / "x.pt"))


def test_merge_matching_matches_jax(capsys):
    from versband_tpu.utils.checkpoint import merge_matching as jax_merge

    params = {"a": {"w": np.zeros((2, 3), np.float32), "b": np.ones(3, np.float32)},
              "c": np.zeros(4, np.float32)}
    loaded = {"a": {"w": np.full((2, 3), 2.0), "b": np.full(5, 3.0)}, "x": np.ones(1)}
    got = port_ckpt.merge_matching(params, loaded, strict=True)
    port_out = capsys.readouterr().out
    want = jax_merge(params, loaded, strict=True)
    jax_out = capsys.readouterr().out
    assert port_out == jax_out and "shape mismatch at /a/b" in port_out
    flat_got, flat_want = port_ckpt.flatten_params(got), port_ckpt.flatten_params(want)
    assert flat_got.keys() == flat_want.keys()
    for k in flat_got:
        assert flat_got[k].dtype == np.asarray(flat_want[k]).dtype
        np.testing.assert_array_equal(flat_got[k], np.asarray(flat_want[k]))
