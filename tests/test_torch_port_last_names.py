"""The last public names of ``versband_tpu`` to get a port twin, each against
its JAX twin (fp32, CPU): the converter's command line
(``utils/convert.py::convert_checkpoint``/``main``), ``normal_kl``,
``ParallelWaveGANGenerator.receptive_field_size``, ``load_dict_from_tsv`` and
``LatentDiffusion.apply_model``/``get_loss``.

The command line runs as a subprocess on a JAX ``.npz`` written by the JAX
package's ``save_npz_params``; the ``.pt`` it writes must load through
``load_model_checkpoint`` equal to the in-process conversion, tensor for
tensor, and the loaded module must answer as the JAX module does within the
parity bars (DiT 5e-4, HiFi-GAN 2e-4).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models import cfm as jcfm
from versband_tpu.models import ldm_variants as jl
from versband_tpu.models.dit import BandMoeDiT as JDiT
from versband_tpu.models.distributions import normal_kl as j_normal_kl
from versband_tpu.utils.checkpoint import save_npz_params
from versband_tpu.utils.tsv import load_dict_from_tsv as j_load_dict
from versband_tpu.vocoder.hifigan import HifiGanGenerator as JGen
from versband_tpu.vocoder.pwg import ParallelWaveGANGenerator as JPWG
from versband_tpu_torch.models import ldm_variants as tl
from versband_tpu_torch.models.cfm import CFM, LatentDiffusion
from versband_tpu_torch.models.dit import BandMoeDiT
from versband_tpu_torch.models.distributions import normal_kl
from versband_tpu_torch.train.checkpoints import load_model_checkpoint
from versband_tpu_torch.utils.convert import state_dict_from_jax
from versband_tpu_torch.utils.tsv import load_dict_from_tsv
from versband_tpu_torch.vocoder.hifigan import HifiGanGenerator
from versband_tpu_torch.vocoder.pwg import ParallelWaveGANGenerator
from torch_port_helpers import (DIT_TINY, PWG_TINY, VOC_TINY, dit_inputs, jax_context,
                                perturb_zero_init, to_jax, torch_context)

REPO = Path(__file__).resolve().parents[1]


def _convert_cli(*args):
    cmd = [sys.executable, "-m", "versband_tpu_torch.utils.convert", *map(str, args)]
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_cli_converts_a_jax_dit(tmp_path):
    torch.manual_seed(0)
    src = BandMoeDiT(**DIT_TINY).eval()
    perturb_zero_init(src, 0)
    params = to_jax(src, "dit")
    save_npz_params(str(tmp_path / "dit.npz"), params)
    r = _convert_cli(tmp_path / "dit.npz", tmp_path / "dit.pt", "--family", "dit")
    assert r.returncode == 0, r.stderr
    assert "dit.pt" in r.stdout

    torch.manual_seed(1)
    model = load_model_checkpoint(BandMoeDiT(**DIT_TINY).eval(), str(tmp_path / "dit.pt"))
    want = state_dict_from_jax(params, "dit")
    _assert_same_state(torch.load(tmp_path / "dit.pt", weights_only=True), want)
    _assert_same_state(model.state_dict(), want)

    x, t, midi, beats, cap = dit_inputs(np.random.RandomState(0), 2, 16, 12, 4)
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x), torch.from_numpy(t), torch_context(midi, beats, cap))
    ref, _ = jax.jit(JDiT(**DIT_TINY).apply)(params, jnp.asarray(x), jnp.asarray(t),
                                             jax_context(midi, beats, cap))
    assert np.abs(out.numpy()).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("weight_norm", [True, False])
def test_cli_converts_a_jax_hifigan(tmp_path, weight_norm):
    # weight-normed as JAX trains it (the converter folds (v, g)), or folded as it serves
    gen = JGen(**VOC_TINY, use_weight_norm=weight_norm)
    mel = np.random.RandomState(1).randn(1, 80, 12).astype(np.float32)
    params = gen.init(jax.random.PRNGKey(3), jnp.asarray(mel))
    save_npz_params(str(tmp_path / "g.npz"), params)
    r = _convert_cli(tmp_path / "g.npz", tmp_path / "g.pt", "--family", "hifigan")
    assert r.returncode == 0, r.stderr

    torch.manual_seed(2)
    model = load_model_checkpoint(HifiGanGenerator(**VOC_TINY).eval(), str(tmp_path / "g.pt"))
    _assert_same_state(model.state_dict(), state_dict_from_jax(params, "hifigan"))
    with torch.no_grad():
        wav = model(torch.from_numpy(mel))
    ref = np.asarray(gen.apply(params, jnp.asarray(mel)))
    assert wav.shape == ref.shape == (1, 12 * 16)
    np.testing.assert_allclose(wav.numpy(), ref, atol=2e-4, rtol=2e-4)


def test_cli_rejects_an_unknown_family(tmp_path):
    save_npz_params(str(tmp_path / "x.npz"), {"params": {"w": np.zeros(2, np.float32)}})
    r = _convert_cli(tmp_path / "x.npz", tmp_path / "x.pt", "--family", "wavenet")
    assert r.returncode != 0
    assert "invalid choice" in r.stderr
    assert not (tmp_path / "x.pt").exists()


def _flax_bert_tree(sd):
    """A Hugging Face torch BERT state_dict in the Flax BERT's layout."""
    tree = {}
    for k, v in sd.items():
        if k.endswith("position_ids"):
            continue
        mod, leaf = k.rsplit(".", 1)
        w = v.numpy()
        if "embeddings" in mod and "LayerNorm" not in mod and leaf == "weight":
            leaf = "embedding"
        elif "LayerNorm" in mod:
            leaf = {"weight": "scale"}.get(leaf, leaf)
        elif leaf == "weight":
            leaf, w = "kernel", w.T
        node = tree
        for part in mod.split("."):
            node = node.setdefault(part, {})
        node[leaf] = w
    return tree


def test_cli_exports_the_clap_bert_tower(tmp_path):
    """``--bert_out`` writes the tree's ``caption_encoder/base`` (the Flax
    BERT's params) as a directory the port's tower loads to the weights; a
    CLAP tree without a tower is refused."""
    from versband_tpu_torch.text.bert import BertModel, load_bert
    from versband_tpu_torch.utils.convert import main
    from torch_port_helpers import BERT_TINY

    # 64-wide heads: the width the directory's geometry is read back with
    bert = BertModel(dict(BERT_TINY, hidden_size=128, num_attention_heads=2))
    bert.init_weights(torch.Generator().manual_seed(5))
    tree = {"params": {"caption_encoder": {"base": _flax_bert_tree(bert.state_dict())},
                       "logit_scale": np.float32(2.5)}}
    save_npz_params(str(tmp_path / "clap.npz"), tree)
    r = _convert_cli(tmp_path / "clap.npz", tmp_path / "clap.pt", "--family", "clap",
                     "--bert_out", tmp_path / "bert")
    assert r.returncode == 0, r.stderr
    assert json.loads((tmp_path / "bert" / "config.json").read_text())["hidden_size"] == 128
    _assert_same_state(load_bert(str(tmp_path / "bert")).state_dict(), bert.state_dict())
    assert float(torch.load(tmp_path / "clap.pt", weights_only=True)["logit_scale"]) == 2.5

    save_npz_params(str(tmp_path / "bare.npz"), {"params": {"logit_scale": np.float32(1.0)}})
    with pytest.raises(ValueError, match="caption_encoder.base"):
        main([str(tmp_path / "bare.npz"), str(tmp_path / "bare.pt"), "--family", "clap",
              "--bert_out", str(tmp_path / "none")])


@pytest.mark.parametrize("shapes", [
    ((2, 3, 4), (2, 3, 4), (1, 3, 1), (3, 1)),
    ((5,), (5,), (), ()),
    ((2, 1, 4), (1, 3, 1), (2, 3, 4), (4,)),
])
def test_normal_kl_matches_jax(shapes):
    rng = np.random.RandomState(len(shapes[0]))
    m1, lv1, m2, lv2 = (np.asarray(rng.randn(*s), np.float32) for s in shapes)
    got = normal_kl(*map(torch.from_numpy, (m1, lv1, m2, lv2)))
    ref = np.asarray(j_normal_kl(*map(jnp.asarray, (m1, lv1, m2, lv2))))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    same = normal_kl(*map(torch.from_numpy, (m1, lv1, m1, lv1)))
    assert float(same.abs().max()) < 1e-6  # KL(p || p) = 0


@pytest.mark.parametrize("kw", [{}, dict(layers=PWG_TINY["layers"], stacks=PWG_TINY["stacks"]),
                                dict(layers=10, stacks=2, kernel_size=5)])
def test_receptive_field_size_matches_jax(kw):
    got = ParallelWaveGANGenerator.receptive_field_size(**kw)
    assert got == JPWG.receptive_field_size(**kw)
    # the generator of that geometry: (k - 1) * its dilations + 1
    gen = ParallelWaveGANGenerator(**{**PWG_TINY, "layers": 30, "stacks": 3, **kw})
    assert got == 1 + sum((b.kernel_size - 1) * b.dilation for b in gen.conv_layers)
    assert ParallelWaveGANGenerator.receptive_field_size() == 6139  # 3 x (1 + 2 + ... + 512)


def test_load_dict_from_tsv_matches_jax(tmp_path):
    p = tmp_path / "m.tsv"
    p.write_text("item_name\tcaption\tlength\n"
                 "a\ta 'quoted' caption\t12\n"
                 "b\t\t7\n"
                 "a\tlater row wins\t3\n", encoding="utf-8")
    got = load_dict_from_tsv(str(p), "item_name")
    assert got == j_load_dict(str(p), "item_name")
    assert list(got) == ["a", "b"] and got["a"]["caption"] == "later row wins"
    assert load_dict_from_tsv(str(p), "length") == j_load_dict(str(p), "length")


def test_apply_model_and_get_loss_match_jax():
    unet = dict(target="versband_tpu.models.dit.BandMoeDiT", params=DIT_TINY)
    torch.manual_seed(0)
    cfm = CFM(unet_config=unet, mel_dim=4, scale_factor=1.0, device="cpu")
    perturb_zero_init(cfm.model, 0)
    jm = jcfm.CFM(unet_config=unet, mel_dim=4, scale_factor=1.0)
    params = to_jax(cfm.model, "dit")
    x, t, midi, beats, cap = dit_inputs(np.random.RandomState(3), 2, 16, 12, 4)
    cond = {"caption": cap, "acoustic": {"midi": midi, "beats": beats}}
    tcond = {"caption": torch.from_numpy(cap),
             "acoustic": {k: torch.from_numpy(v) for k, v in cond["acoustic"].items()}}
    jcond = jax.tree_util.tree_map(jnp.asarray, cond)
    with torch.no_grad():
        out, lb = cfm.apply_model(torch.from_numpy(x), torch.from_numpy(t), tcond)
    ref, ref_lb = jax.jit(jm.apply_model)(params, jnp.asarray(x), jnp.asarray(t), jcond)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(float(lb), float(ref_lb), atol=5e-4, rtol=5e-4)
    assert np.abs(out.numpy()).max() > 1e-2

    target = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    loss = cfm.get_loss(out, torch.from_numpy(target))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jm.get_loss(ref, jnp.asarray(target))),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_array_equal(cfm.get_loss(torch.from_numpy(x), torch.from_numpy(target)),
                                  np.asarray(jm.get_loss(jnp.asarray(x), jnp.asarray(target))))


def test_subclass_apply_models_still_win():
    """Every LDM variant that overrides ``apply_model`` in JAX does in the port."""
    jax_own = {n for n, c in vars(jl).items() if isinstance(c, type)
               and issubclass(c, jcfm.LatentDiffusion) and c is not jcfm.LatentDiffusion
               and "apply_model" in vars(c)}
    port_own = {n for n, c in vars(tl).items() if isinstance(c, type)
                and issubclass(c, LatentDiffusion) and c is not LatentDiffusion
                and "apply_model" in vars(c)}
    assert jax_own == port_own == {"LatentDiffusionInpaint", "LatentDiffusionOrder"}
    for n in port_own:
        cls = getattr(tl, n)
        assert cls.apply_model is not LatentDiffusion.apply_model
        assert cls.apply_model.__qualname__ == f"{n}.apply_model"
