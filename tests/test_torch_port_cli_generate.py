"""Golden test of the port's inference CLI against the JAX package's.

Both ``main``s run a tiny copy of ``configs/vocal2music.yaml`` (written by the
test) over one manifest item at ``--scales 1-2``, with the same DiT and VAE
``.npz``, the same local T5 directory (weights and ``tokenizer.json``), the
same HiFi-GAN ``model_gen.npz`` and the same start noise injected into both
samplers. The wavs agree within 1e-3 of full scale (16-bit PCM after -23
LUFS: fp32 through T5, 24 Euler steps, the VAE and HiFi-GAN, in another
order), ``clap.csv`` and the file names are identical. Also: the manifest
reader and ``InferDataset`` against JAX's on cells pandas reads as NaN,
``--pad_to`` trimming, and a ``--nproc 2 --platform cpu`` merge.
"""

import glob
import json
import math
import os

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from versband_tpu_torch.cli import generate as port_cli
from torch_port_helpers import (caption_corpus, perturb_zero_init, to_jax,
                                train_unigram_tokenizer, write_t5_dir)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAV_TOL = 1e-3 * 32767  # 1e-3 of full scale, in 16-bit counts
T_FRAMES = 37  # padded to 40 by InferDataset; latent 20
DIT = dict(in_channels=4, ori_dim=16, context_dim=16, hidden_size=16, num_heads=2, depth=1,
           max_len=64, num_experts=2, multiple_of=8, use_flash=False)
DDCONFIG = dict(double_z=True, in_channels=80, out_ch=80, z_channels=4, kernel_size=5, ch=8,
                ch_mult=[1, 2], num_res_blocks=1, attn_layers=[], down_layers=[0], dropout=0.0)
T5 = dict(d_model=16, d_ff=32, d_kv=8, num_heads=2, num_layers=2, vocab_size=256,
          feed_forward_proj="gated-gelu")
VOC = dict(upsample_initial_channel=16, upsample_rates=[5, 4, 4, 4],
           upsample_kernel_sizes=[9, 8, 8, 8], resblock_kernel_sizes=[3, 7],
           resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5]])


def _write_manifest(root, rows, T=T_FRAMES, seed=0):
    rng = np.random.default_rng(seed)
    mdir = root / "manifest"
    mdir.mkdir()
    midi, beats = {}, {}
    lines = ["\t".join(rows[0].keys())]
    for r in rows:
        mel = root / f"{r['name']}_vocal_mel.npy"
        np.save(mel, (rng.standard_normal((80, T)) * 0.5).astype(np.float32))
        r["vocal_mel_path"] = str(mel)
        midi[r["name"]] = rng.integers(0, 128, T).astype(np.int64)
        beats[r["name"]] = rng.integers(0, 2, T).astype(np.int64)
    cols = list(rows[0].keys())
    lines = ["\t".join(cols)] + ["\t".join(str(r[c]) for c in cols) for r in rows]
    (mdir / "music.tsv").write_text("\n".join(lines) + "\n")
    np.save(root / "midi.npy", midi, allow_pickle=True)
    np.save(root / "beats.npy", beats, allow_pickle=True)
    return str(mdir), str(root / "midi.npy")


def _row(name, **kw):
    row = dict(name=name, caption="piano<psep>a soft piano accompaniment", duration=10.0,
               key="C major", key_confidence=0.9, avg_pitch=66.0, tempo=100.0,
               tempo_confidence=0.9, wav_len=10.0, audio_path="")
    row.update(kw)
    return row


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    from versband_tpu.utils.checkpoint import save_npz_params
    from versband_tpu_torch.models.autoencoder import AutoencoderKL
    from versband_tpu_torch.models.dit import BandMoeDiT
    from versband_tpu_torch.vocoder.hifigan import HifiGanGenerator

    root = tmp_path_factory.mktemp("cli_golden")
    t5_dir = root / "flan-t5"
    write_t5_dir(t5_dir, T5, seed=1, tokenizer=train_unigram_tokenizer(caption_corpus()))

    with open(os.path.join(REPO, "configs", "vocal2music.yaml")) as f:
        cfg = yaml.safe_load(f)
    p = cfg["model"]["params"]
    p["mel_dim"] = 4
    p["unet_config"]["params"] = dict(DIT)
    p["first_stage_config"]["params"].update(embed_dim=4, ddconfig=DDCONFIG)
    p["cond_stage_config"]["params"] = dict(version=str(t5_dir), max_length=16)
    (root / "tiny.yaml").write_text(yaml.safe_dump(cfg))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        dit = BandMoeDiT(**{k: v for k, v in DIT.items() if k != "use_flash"}).eval()
        perturb_zero_init(dit, 5)
        vae = AutoencoderKL(embed_dim=4, ddconfig=DDCONFIG).eval()
        voc = HifiGanGenerator(**VOC).eval()
    (root / "dit").mkdir()
    save_npz_params(str(root / "dit" / "dit.npz"), to_jax(dit, "dit"))
    (root / "dit" / "last_step.json").write_text(json.dumps({"step": 2, "scale_factor": 0.8}))
    save_npz_params(str(root / "vae.npz"), to_jax(vae, "vae"))
    (root / "hifigan").mkdir()
    save_npz_params(str(root / "hifigan" / "model_gen.npz"),
                    to_jax(voc, "hifigan", num_resblock_kernels=2))
    (root / "hifigan" / "config.yaml").write_text(yaml.safe_dump(
        {"audio_num_mel_bins": 80, **VOC, "resblock": "1"}))
    manifest, midi = _write_manifest(root, [_row("song0")])
    return dict(root=root, config=str(root / "tiny.yaml"), manifest=manifest, midi=midi,
                args=["--config", str(root / "tiny.yaml"), "--ckpt", str(root / "dit" / "dit.npz"),
                      "--vae_ckpt", str(root / "vae.npz"),
                      "--vocoder_ckpt", str(root / "hifigan"), "--manifest", manifest,
                      "--other_condition", midi, "--scales", "1-2", "--num_items", "1",
                      "--seed", "3", "--save_dir", "gen_out"])


def _noise():
    """The start noise of each (item, scale), in call order, for either CLI."""
    rng = np.random.RandomState(11)
    return lambda shape: rng.standard_normal(tuple(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def golden(assets, tmp_path_factory):
    import jax.numpy as jnp
    from versband_tpu.cli import generate as jax_cli
    from versband_tpu.models import cfm as jax_cfm

    mp = pytest.MonkeyPatch()
    out = {}
    try:
        draw = _noise()
        orig = jax_cfm.CFMSampler.sample_cfg

        def jax_sample(self, params, cond, scale, uncond, key, batch_size=None, shape=None,
                       x_latent=None, t_start=0):
            T = cond["acoustic"]["acoustic"].shape[2]
            x0 = jnp.asarray(draw((batch_size, self.model.mel_dim, math.ceil(T / 2))))
            return orig(self, params, cond, scale, uncond, key, batch_size=batch_size,
                        x_latent=x0)

        mp.setattr(jax_cfm.CFMSampler, "sample_cfg", jax_sample)
        out["jax"] = tmp_path_factory.mktemp("jax_run")
        mp.chdir(out["jax"])
        assert jax_cli.main(list(assets["args"])) == 0

        draw = _noise()
        mp.setattr(port_cli, "start_noise",
                   lambda gen, shape, device: torch.from_numpy(draw(shape)).to(device))
        out["port"] = tmp_path_factory.mktemp("port_run")
        mp.chdir(out["port"])
        assert port_cli.main(assets["args"] + ["--platform", "cpu"]) == 0
    finally:
        mp.undo()
    return out


def _wavs(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "gen_out", "**", "*.wav"), recursive=True))


def test_same_files(golden):
    names = _wavs(golden["jax"])
    assert names == _wavs(golden["port"])
    assert names == [os.path.join("gen_out", f"cond_gtcodec_accomp_scale_{s}",
                                  "0-0000[0][accomp].wav") for s in (1.0, 2.0)]


def test_wavs_match_jax(golden):
    for name in _wavs(golden["jax"]):
        sr_j, want = wavfile.read(os.path.join(golden["jax"], name))
        sr_p, got = wavfile.read(os.path.join(golden["port"], name))
        assert sr_j == sr_p == 24000 and got.dtype == want.dtype == np.int16
        assert got.shape == want.shape == (40 * 320,)
        assert np.abs(want).max() > 1000  # -23 LUFS: not silence
        err = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
        assert err <= WAV_TOL, (name, err)


def test_clap_csv_matches_jax(golden):
    a = (golden["jax"] / "gen_out" / "clap.csv").read_bytes()
    b = (golden["port"] / "gen_out" / "clap.csv").read_bytes()
    assert a == b
    assert len(a.decode().strip().split("\n")) == 1 + 2  # header + item x scales


def test_pad_to_trims_to_the_true_length(assets, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = [a if a != "1-2" else "2" for a in assets["args"]]
    assert port_cli.main(args + ["--platform", "cpu", "--pad_to", "64"]) == 0
    (path,) = glob.glob(str(tmp_path / "gen_out" / "**" / "*.wav"), recursive=True)
    assert wavfile.read(path)[1].shape == (40 * 320,)  # 64 frames sampled, 40 kept


def test_vocoder_nsf_serves(assets, tmp_path, monkeypatch):
    """``--vocoder nsf``: the HiFi-GAN NSF wrapper reads the directory's
    config.yaml (no ``model_ckpt_steps_*`` there: a seeded random init) and
    estimates each mel's f0."""
    monkeypatch.chdir(tmp_path)
    args = [a if a != "1-2" else "1" for a in assets["args"]]
    assert port_cli.main(args + ["--platform", "cpu", "--vocoder", "nsf"]) == 0
    (path,) = glob.glob(str(tmp_path / "gen_out" / "**" / "*.wav"), recursive=True)
    sr, wav = wavfile.read(path)
    assert sr == 24000 and wav.shape == (40 * 320,) and np.abs(wav).max() > 0


def test_infer_dataset_matches_jax(tmp_path):
    """Empty cells (NaN in pandas), numeric columns, the duration filter and
    the random subset: the same items, captions and arrays as JAX's."""
    from versband_tpu.cli.generate import InferDataset as JaxDataset

    rows = [_row("a"), _row("b", caption="", key="", key_confidence=0.1, tempo=""),
            _row("c", duration=25.0), _row("d", key_confidence="", avg_pitch=""),
            _row("e", caption="rock<psep>drums<psep>bass", audio_path="x/accomp.wav"),
            _row("f", tempo=70.0, tempo_confidence=""), _row("g", key="None", key_confidence=0.2)]
    manifest, midi = _write_manifest(tmp_path, rows)
    for num_items in (3, 10):
        jd = JaxDataset(manifest, midi, num_items=num_items, max_sec=20.0, seed=4)
        pd_ = port_cli.InferDataset(manifest, midi, num_items=num_items, max_sec=20.0, seed=4)
        assert len(jd) == len(pd_) == min(num_items, 6)
        for i in range(len(jd)):
            j, p = jd[i], pd_[i]
            assert p["name"] == j["name"] and p["caption"] == j["caption"]
            for k in ("acoustic", "midi", "beats"):
                np.testing.assert_array_equal(p[k], j[k])
            ja, pa = j["audio_path"], p["audio_path"]
            assert (isinstance(ja, float) and math.isnan(ja) and math.isnan(pa)) or ja == pa
        assert any("Style: nan" in jd[i]["caption"] for i in range(len(jd))) or num_items == 3


def test_nproc_merge(assets, tmp_path, monkeypatch):
    """Two child ranks on the CPU; the merged clap.csv holds the rows the two
    ranks write when run one by one, and stale rank files are swept."""
    root = tmp_path / "data"
    root.mkdir()
    manifest, midi = _write_manifest(root, [_row(f"s{i}") for i in range(3)])
    args = list(assets["args"])
    args[args.index("--manifest") + 1] = manifest
    args[args.index("--other_condition") + 1] = midi
    args[args.index("--num_items") + 1] = "3"
    args[args.index("--scales") + 1] = "1"
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    (tmp_path / "fan").mkdir()
    (tmp_path / "fan" / "clap_rank7.csv").write_text("audio_path\tcaption\tname\nS\tS\tS\n")
    fan = [a if a != "gen_out" else "fan" for a in args]
    assert port_cli.main(fan + ["--platform", "cpu", "--nproc", "2"]) == 0
    merged = (tmp_path / "fan" / "clap.csv").read_text().strip().split("\n")
    assert not (tmp_path / "fan" / "clap_rank7.csv").exists()
    rows = []
    for r in range(2):
        one = [a if a != "gen_out" else f"one{r}" for a in args]
        assert port_cli.main(one + ["--platform", "cpu", "--rank", str(r), "--world", "2"]) == 0
        lines = (tmp_path / f"one{r}" / f"clap_rank{r}.csv").read_text().strip().split("\n")
        rows += [l.replace(f"one{r}/", "fan/") for l in lines[1:]]
    assert merged[0] == "audio_path\tcaption\tname" and merged[1:] == rows
    assert sorted(l.split("\t")[2] for l in merged[1:]) == ["s0", "s1", "s2"]
