"""Inference CLI (port of ``versband_tpu/cli/generate.py``).

    python -m versband_tpu_torch.cli.generate --config configs/vocal2music.yaml \\
        --ckpt <dit.pt|dit.npz> --vae_ckpt <vae.pt|vae.npz> --vocoder_ckpt <dir> \\
        --manifest <dir> --other_condition <midi.npy> --scales 1-2 --save_dir out/

Runs on the card unless ``--platform cpu`` is given. Per manifest item
(duration <= ``--max_sec``, ``--num_items`` random picks) and per CFG scale:
the frozen T5 tower encodes the caption (and ``""`` when some scale is not
1), the CFG Euler sampler runs the DiT (flash attention on the card when the
config sets ``use_flash``), the VAE decodes, the vocoder renders, the
waveform is normalised to -23 LUFS, and the accompaniment (and, where the
manifest names source audio, the ground-truth and mixed song) wavs are
written with a ``clap.csv`` manifest for CLAP evaluation
(``scripts/test_final.py:349-465``).

Items are rank-strided (``[rank::world]``); ``--nproc N`` runs N ranks as
child processes and merges their CSVs. The start noise of each (item, scale)
comes from :func:`start_noise` with a ``torch.Generator`` seeded by
``--seed``.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from versband_tpu_torch.device import DeviceLike, resolve_device
from versband_tpu_torch.dsp.audio_io import safe_path, write_wav  # noqa: F401 (CLI API)

CSV_COLUMNS = ["audio_path", "caption", "name"]


def get_parser():
    p = argparse.ArgumentParser("versband_tpu_torch generate")
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default=None, help="CFM (DiT) checkpoint: .pt, .npz or .ckpt")
    p.add_argument("--vae_ckpt", default=None, help="override first-stage checkpoint")
    p.add_argument("--vocoder_ckpt", default=None)
    p.add_argument("--scale_factor", type=float, default=None,
                   help="scale_by_std latent scale override (defaults to the value saved "
                        "beside the checkpoint)")
    p.add_argument("--vocoder", default="hifigan", choices=("hifigan", "nsf", "bigvgan", "pwg"),
                   help="vocoder family (reference serves hifigan, test_final.py:420)")
    p.add_argument("--manifest", default=None, help="manifest dir (defaults to config data path)")
    p.add_argument("--other_condition", default=None, help="midi.npy path")
    p.add_argument("--save_dir", default="gen_out")
    p.add_argument("--scales", default="1-2-3")
    p.add_argument("--ddim_steps", type=int, default=25)
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--num_items", type=int, default=200)
    p.add_argument("--max_sec", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--nproc", type=int, default=1,
                   help="run N rank-strided workers as child processes and merge their clap "
                        "CSVs (the mp.spawn equivalent, test_final.py:467-477). On a one-card "
                        "host pass --platform cpu so the children do not share the card.")
    p.add_argument("--platform", default=None,
                   help="'cpu' to run on the CPU; default: the card (cuda)")
    p.add_argument("--pad_to", type=int, default=0,
                   help="pad conditions to a fixed mel length (frames); wavs are trimmed to "
                        "the true length")
    return p


class InferDataset:
    """Manifest plus midi/beats dicts, filtered to <= max_sec, a random subset
    (``test_final.py:196-340``)."""

    def __init__(self, manifest_dir: str, other_condition: Optional[str],
                 num_items: int = 200, max_sec: float = 20.0, seed: int = 0,
                 mel_downsample_rate: int = 2, caption_templates: str = "reference"):
        # generation from a converted reference checkpoint should see the
        # prompt distribution it was trained on -> reference templates
        from versband_tpu_torch.data.manifests import load_manifest_dirs
        from versband_tpu_torch.text.caption_generator import CaptionGenerator2

        self.rng = np.random.default_rng(seed)
        self.caption_generator = CaptionGenerator2(rng=self.rng, templates=caption_templates)
        df = load_manifest_dirs(manifest_dir)
        if "duration" in df:
            df = df.where([r["duration"] <= max_sec for r in df.rows])
        if len(df) > num_items:
            pick = self.rng.choice(len(df), num_items, replace=False)
            df = df.take(sorted(pick))
        self.df = df
        self.mel_downsample_rate = mel_downsample_rate
        self.midi_dict, self.beats_dict = {}, {}
        if other_condition:
            self.midi_dict = np.load(other_condition, allow_pickle=True).item()
            self.beats_dict = np.load(other_condition.replace("midi", "beats"),
                                      allow_pickle=True).item()

    def __len__(self) -> int:
        return len(self.df)

    def __getitem__(self, i: int) -> Dict:
        from versband_tpu_torch.data.collate import pad_or_cut_xd
        from versband_tpu_torch.data.vocal2accomp import BEATS_PAD, MIDI_PAD

        data = self.df[i]
        acoustic = np.load(data["vocal_mel_path"])[:20, :].astype(np.float32)
        name = data["name"]
        T = acoustic.shape[1]
        midi = np.asarray(self.midi_dict.get(name, np.full(T, MIDI_PAD)), np.float32)[None]
        beats = np.asarray(self.beats_dict.get(name, np.full(T, BEATS_PAD)), np.float32)[None]
        T8 = int(math.ceil(T / 8) * 8)
        acoustic = pad_or_cut_xd(acoustic, T8, 1, -5.0)
        midi = pad_or_cut_xd(midi, T8, 1, MIDI_PAD)
        beats = pad_or_cut_xd(beats, T8, 1, BEATS_PAD)

        caption = ""
        if "caption" in data:
            choices = str(data["caption"]).split("<psep>")
            caption = f"Style: {choices[int(self.rng.integers(len(choices)))]} "
        prompt = self.caption_generator.transcribe(
            key=data.get("key"), key_conf=float(data.get("key_confidence", 0)),
            avg_pitch=float(data.get("avg_pitch", 0)), tempo=float(data.get("tempo", 0)),
            tempo_conf=float(data.get("tempo_confidence", 0)), emotion=None,
            duration=float(data.get("wav_len", 0)))
        caption = caption + f"Musical: {prompt}"
        return dict(name=name, caption=caption, acoustic=acoustic, midi=midi, beats=beats,
                    audio_path=data.get("audio_path", ""))


def build_vocoder(name: str, ckpt: Optional[str] = None, device: DeviceLike = None,
                  dtype: torch.dtype = torch.float32, **generator):
    """The runtime wrapper of vocoder family ``name`` (``--vocoder``), on
    ``device`` (``None``: the card) in ``dtype``; ``generator`` overrides the
    wrapper's generator geometry (keys of its config). Every wrapper serves
    ``wrapper(mel_2d) -> np.ndarray`` and ``wrapper.waveform(mel) ->`` a
    device tensor (``nsf`` estimates each mel's f0 on the host)."""
    if name == "hifigan":
        from versband_tpu_torch.vocoder.hifigan import HifiGAN
        return HifiGAN(ckpt, device=device, dtype=dtype, **generator)
    if name == "bigvgan":
        from versband_tpu_torch.vocoder.bigvgan import VocoderBigVGAN
        return VocoderBigVGAN(ckpt, device=device, dtype=dtype, **generator)
    if name == "pwg":
        from versband_tpu_torch.vocoder.pwg import ParallelWaveGAN
        return ParallelWaveGAN(ckpt, device=device, dtype=dtype, **generator)
    if name == "nsf":
        from versband_tpu_torch.vocoder.nsf import HifiGAN_NSF
        return HifiGAN_NSF(ckpt, device=device, dtype=dtype, **generator)
    raise ValueError(f"unknown vocoder family: {name}")


def start_noise(generator: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    """The sampler's start noise of one (item, scale): float32 normal."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def _merge_rank_csvs(save_dir: str, nproc: int) -> None:
    from versband_tpu_torch.data.manifests import concat, read_tsv, write_tsv

    parts = [p for p in (os.path.join(save_dir, f"clap_rank{r}.csv") for r in range(nproc))
             if os.path.exists(p)]
    if parts:
        merged = concat([read_tsv(p) for p in parts])
        write_tsv(os.path.join(save_dir, "clap.csv"), merged.columns, merged.rows)
        print(f"merged {len(parts)} rank CSVs -> clap.csv ({len(merged)} rows)")


def _restore_scale_factor(cfm, opt) -> None:
    """scale_by_std models train with scale_factor = 1/std(z) of the first
    batch; the trainer saves it beside the checkpoint, and without it the VAE
    decodes sampled latents at the wrong amplitude."""
    if opt.scale_factor is not None:
        cfm.scale_factor = float(opt.scale_factor)
    elif opt.ckpt and getattr(cfm, "scale_by_std", False) and cfm.scale_factor == 1.0:
        meta_path = os.path.join(os.path.dirname(os.path.abspath(opt.ckpt)), "last_step.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                sf = json.load(f).get("scale_factor")
            if sf:
                cfm.scale_factor = float(sf)
                print(f"Restored scale_factor={cfm.scale_factor:.5f}")
        else:
            print("WARNING: scale_by_std=true but no saved scale_factor found; decoding with "
                  "scale_factor=1.0")


def main(argv: List[str] = None) -> int:
    opt = get_parser().parse_args(argv)
    if opt.nproc > 1:
        from versband_tpu_torch.utils.fanout import spawn_ranks

        # stale rank CSVs from an earlier (larger or failed) run would be merged
        for stale in glob.glob(os.path.join(opt.save_dir, "clap_rank*.csv")):
            os.remove(stale)
        rc = spawn_ranks("versband_tpu_torch.cli.generate",
                         argv if argv is not None else sys.argv[1:], opt.nproc)
        if rc == 0:
            _merge_rank_csvs(opt.save_dir, opt.nproc)
        return rc

    from versband_tpu_torch.data.collate import pad_or_cut_xd
    from versband_tpu_torch.data.manifests import write_tsv
    from versband_tpu_torch.data.vocal2accomp import BEATS_PAD, MIDI_PAD
    from versband_tpu_torch.dsp.loudness import normalize_loudness
    from versband_tpu_torch.models.cfm import CFMSampler
    from versband_tpu_torch.train.checkpoints import load_model_checkpoint
    from versband_tpu_torch.utils.config import instantiate_from_config, load_config

    device = resolve_device(opt.platform)
    config = load_config(opt.config)
    model_cfg = config["model"]
    # the DiT and VAE init where no checkpoint is given, made on the device
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(opt.seed)
        cfm = instantiate_from_config(model_cfg, device=device)
    sampler = CFMSampler(cfm, num_timesteps=opt.ddim_steps)

    data_params = config["data"]["params"]
    manifest = opt.manifest or data_params.get("main_spec_dir_path")
    other_cond = opt.other_condition or data_params.get("other_condition")
    dataset = InferDataset(manifest, other_cond, opt.num_items, opt.max_sec, opt.seed)
    scales = [float(s) for s in str(opt.scales).split("-") if s]
    dataset[0]  # as the JAX CLI, which sizes its params from item 0 (its draws count)
    B = opt.n_samples

    if opt.ckpt:
        load_model_checkpoint(cfm.model, opt.ckpt)
        print(f"Restored DiT from {opt.ckpt}")
    _restore_scale_factor(cfm, opt)
    fs_cfg = model_cfg["params"]["first_stage_config"]
    vae_ckpt = opt.vae_ckpt or (fs_cfg.get("params") or {}).get("ckpt_path")
    if vae_ckpt and os.path.exists(str(vae_ckpt)):
        load_model_checkpoint(cfm.first_stage, str(vae_ckpt))
        print(f"Restored VAE from {vae_ckpt}")
    vocoder = build_vocoder(opt.vocoder, opt.vocoder_ckpt, device=device)
    generator = torch.Generator(device=device).manual_seed(opt.seed)

    csv_rows = []
    items = list(range(len(dataset)))[opt.rank::opt.world]
    for item_idx, i in enumerate(items):
        item = dataset[i]
        true_frames = item["acoustic"].shape[1]
        if opt.pad_to:
            item = dict(item)
            item["acoustic"] = pad_or_cut_xd(item["acoustic"], opt.pad_to, 1, -5.0)
            item["midi"] = pad_or_cut_xd(item["midi"], opt.pad_to, 1, MIDI_PAD)
            item["beats"] = pad_or_cut_xd(item["beats"], opt.pad_to, 1, BEATS_PAD)
        acoustic = torch.from_numpy(np.stack([item["acoustic"]] * B)).to(device)
        midi = torch.from_numpy(np.stack([item["midi"]] * B).astype(np.int64)).to(device)
        beats = torch.from_numpy(np.stack([item["beats"]] * B).astype(np.int64)).to(device)

        def learned(caption_text):
            cond = {"caption": [caption_text] * B,
                    "acoustic": {"acoustic": acoustic, "midi": midi, "beats": beats},
                    "name": [item["name"]] * B}
            return cfm.get_learned_conditioning(cond)

        c = learned(item["caption"])
        # the uncond pass only where some scale applies CFG (uncond keeps the
        # acoustic conditions, test_final.py:401-407)
        uc = learned("") if any(s != 1.0 for s in scales) else None
        for scale in scales:
            shape = (B, cfm.mel_dim, cfm.latent_length(acoustic.shape[2]))
            x0 = start_noise(generator, shape, device)
            z = sampler.sample_cfg(c, scale, None if scale == 1.0 else uc, batch_size=B,
                                   x_latent=x0)
            mels = cfm.decode_first_stage(z)
            out_dir = os.path.join(opt.save_dir, f"cond_gtcodec_accomp_scale_{scale}")
            for widx, mel in enumerate(mels):
                wav = vocoder(mel)
                if opt.pad_to:
                    wav = wav[: true_frames * 320]  # trim the padding's tail
                wav = normalize_loudness(wav, -23.0)
                path = os.path.join(out_dir, f"{opt.rank}-{item_idx:04d}[{widx}][accomp].wav")
                write_wav(path, wav)
                csv_rows.append({"audio_path": path, "caption": item["caption"],
                                 "name": item["name"]})
                # gt vocal + mixed song where source audio exists (an empty
                # manifest cell is NaN: only a non-empty string is a path)
                gt = item.get("audio_path")
                if isinstance(gt, str) and gt and os.path.exists(gt):
                    _write_ground_truth(gt, wav, out_dir, f"{opt.rank}-{item_idx:04d}[{widx}]",
                                        normalize_loudness)
        print(f"[{opt.rank}] {item_idx + 1}/{len(items)} {item['name']}")

    csv_name = "clap.csv" if opt.world == 1 else f"clap_rank{opt.rank}.csv"
    csv_path = os.path.join(opt.save_dir, csv_name)
    os.makedirs(opt.save_dir, exist_ok=True)
    write_tsv(csv_path, CSV_COLUMNS, csv_rows)
    print(f"wrote {csv_path}")
    return 0


def _write_ground_truth(gt_path: str, wav: np.ndarray, out_dir: str, stem: str,
                        normalize_loudness) -> None:
    """The gt accompaniment, and where its vocal exists the gt vocal and the
    song (generated accompaniment + gt vocal), all at -23 LUFS."""
    from scipy.io import wavfile

    _, gt_accomp = wavfile.read(gt_path)
    gt_accomp = gt_accomp.astype(np.float32) / 32768.0
    vocal_path = gt_path.replace("accomp", "vocal")
    if os.path.exists(vocal_path):
        _, gt_vocal = wavfile.read(vocal_path)
        gt_vocal = normalize_loudness(gt_vocal.astype(np.float32) / 32768.0, -23.0)
        n = min(len(wav), len(gt_vocal))
        write_wav(os.path.join(out_dir, f"{stem}[gt_vocal].wav"), gt_vocal[:n])
        write_wav(os.path.join(out_dir, f"{stem}[song].wav"), wav[:n] + gt_vocal[:n])
    write_wav(os.path.join(out_dir, f"{stem}[gt_accomp].wav"),
              normalize_loudness(gt_accomp, -23.0))


if __name__ == "__main__":
    raise SystemExit(main())
