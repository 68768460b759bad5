"""Config trees, dotted overrides and instantiation from ``target`` strings.

The port's own copy of ``load_config``, ``merge_configs`` and
``apply_dot_overrides`` (reference: ``versband_tpu/utils/config.py``). Target
strings of the reference repo (``ldm.*``, ``vocoder.*``) and of the JAX package
(``versband_tpu.*``) resolve to this package, so ``configs/vocal2music.yaml``
builds the port unchanged. YAML is read and written by the port's own
:mod:`versband_tpu_torch.utils.yaml_subset`, so no PyYAML is needed.
"""

from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Iterable, Mapping

from versband_tpu_torch.utils import yaml_subset

_JAX_PKG = "versband_tpu."
_PORT_PKG = "versband_tpu_torch."

# Reference dotted targets -> the JAX package's names (a copy of
# versband_tpu/utils/config.py's table); those are then mapped onto this
# package by prefix.
TARGET_ALIASES = {
    "ldm.models.autoencoder1d.AutoencoderKL": "versband_tpu.models.autoencoder.AutoencoderKL",
    "ldm.models.diffusion.cfm1_audio.CFM": "versband_tpu.models.cfm.CFM",
    "ldm.models.diffusion.ddpm_audio.LatentDiffusion_audio": "versband_tpu.models.cfm.LatentDiffusion",
    "ldm.models.diffusion.ddpm_audio_order.LatentDiffusion_audio": "versband_tpu.models.ldm_variants.LatentDiffusionOrder",
    "ldm.models.diffusion.ddpm.LatentDiffusion": "versband_tpu.models.cfm.LatentDiffusion",
    "ldm.models.diffusion.audioldm.LatentDiffusion": "versband_tpu.models.ldm_variants.AudioLDM",
    "ldm.models.diffusion.ddpm_audio_inpaint.LatentDiffusion_audioinpaint": "versband_tpu.models.ldm_variants.LatentDiffusionInpaint",
    "ldm.models.diffusion.classifier.NoisyLatentImageClassifier": "versband_tpu.models.ldm_variants.NoiseLevelClassifier",
    "ldm.modules.diffusionmodules.vocal2music_moe.TxtFlagLargeImprovedDiTV2": "versband_tpu.models.dit.BandMoeDiT",
    "ldm.modules.diffusionmodules.vocal2music_moe.TxtFlagLargeDiT": "versband_tpu.models.dit.BandMoeDiT",
    "ldm.modules.diffusionmodules.flag_large_dit_moe.VideoFlagLargeDiT": "versband_tpu.models.dit_timefreq.TimeFreqMoeDiT",
    "ldm.modules.diffusionmodules.concatDiT.ConcatDiT2MLP": "versband_tpu.models.concat_dit.ConcatDiT2MLP",
    "ldm.modules.encoders.modules.FrozenTextVocalEmbedder": "versband_tpu.text.embedders.TextVocalEmbedder",
    "ldm.modules.encoders.modules.FrozenTextVocalMusicalEmbedder": "versband_tpu.text.embedders.TextVocalMusicalEmbedder",
    "ldm.modules.encoders.modules.FrozenFLANEmbedder": "versband_tpu.text.embedders.FlanT5Embedder",
    "ldm.modules.encoders.modules.FrozenCLAPEmbedder": "versband_tpu.text.embedders.ClapTextEmbedder",
    "ldm.modules.encoders.modules.FrozenCLAPFLANEmbedder": "versband_tpu.text.embedders.ClapFlanEmbedder",
    "ldm.modules.losses_audio.contperceptual.LPAPSWithDiscriminator": "versband_tpu.train.gan_losses.VAEGANLoss",
    "torch.nn.Identity": "versband_tpu.utils.config.Identity",
    "vocoder.hifigan.hifigan.HifiGAN": "versband_tpu.vocoder.hifigan.HifiGAN",
    "vocoder.hifigan.hifigan_nsf.HifiGAN_NSF": "versband_tpu.vocoder.nsf.HifiGAN_NSF",
    "vocoder.bigvgan.models.VocoderBigVGAN": "versband_tpu.vocoder.bigvgan.VocoderBigVGAN",
    "ldm.models.autoencoder.AutoencoderKL": "versband_tpu.models.autoencoder2d.AutoencoderKL2D",
    "ldm.models.autoencoder.VQModel": "versband_tpu.models.autoencoder2d.VQModel",
    "ldm.models.autoencoder.VQModelInterface": "versband_tpu.models.autoencoder2d.VQModelInterface",
    "ldm.models.autoencoder.IdentityFirstStage": "versband_tpu.models.autoencoder2d.IdentityFirstStage",
    "ldm.modules.encoders.modules.ClassEmbedder": "versband_tpu.text.embedders.ClassEmbedder",
    "ldm.modules.encoders.modules.SpatialRescaler": "versband_tpu.text.embedders.SpatialRescaler",
    "ldm.modules.diffusionmodules.concatDiT.ConcatDiT": "versband_tpu.models.concat_dit.ConcatDiT",
    "ldm.modules.diffusionmodules.concatDiT.HybridDiT2MLP": "versband_tpu.models.concat_dit.HybridDiT2MLP",
    "ldm.modules.diffusionmodules.concatDiT.HybridDiT2MLP2": "versband_tpu.models.concat_dit.HybridDiT2MLP2",
    "ldm.modules.diffusionmodules.concatDiT.ConcatOrderDiT": "versband_tpu.models.concat_dit.ConcatOrderDiT",
    "ldm.modules.diffusionmodules.concatDiT.ConcatOrderDiT2": "versband_tpu.models.concat_dit.ConcatOrderDiT2",
    "ldm.lr_scheduler.LambdaLinearScheduler": "versband_tpu.train.lr_schedules.LambdaLinearScheduler",
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler": "versband_tpu.train.lr_schedules.LambdaWarmUpCosineScheduler",
    "ldm.data.vocal2accomp_musical_dataset.JoinSpecsTrain": "versband_tpu.data.vocal2accomp.JoinSpecsTrain",
    "ldm.data.vocal2accomp_musical_dataset.JoinSpecsValidation": "versband_tpu.data.vocal2accomp.JoinSpecsValidation",
    "ldm.data.vocal2accomp_dataset.JoinSpecsTrain": "versband_tpu.data.vocal2accomp.JoinSpecsTrain",
    "ldm.data.vocal2accomp_dataset.JoinSpecsValidation": "versband_tpu.data.vocal2accomp.JoinSpecsValidation",
    "ldm.data.joinaudiodataset_624.JoinSpecsTrain": "versband_tpu.data.fixed_len.JoinSpecsTrain",
    "ldm.data.joinaudiodataset_624.JoinSpecsValidation": "versband_tpu.data.fixed_len.JoinSpecsValidation",
    "ldm.data.tsvdataset.TSVDataset": "versband_tpu.data.tsvdataset.TSVDataset",
    "ldm.data.tsvdataset.TSVDatasetStruct": "versband_tpu.data.tsvdataset.TSVDatasetStruct",
    "ldm.data.joinaudiodataset_struct_sample_anylen.JoinSpecsTrain": "versband_tpu.data.anylen.JoinSpecsTrain",
    "ldm.data.joinaudiodataset_anylen.JoinSpecsTrain": "versband_tpu.data.anylen.JoinSpecsTrain",
    "ldm.data.joinaudiodataset_anylen.JoinSpecsValidation": "versband_tpu.data.anylen.JoinSpecsValidation",
    "vocoder.hifigan.modules.hifigan.CodeUpsampleHifiGanGenerator": "versband_tpu.vocoder.hifigan.CodeUpsampleHifiGanGenerator",
    "main.AudioLogger": "versband_tpu.train.callbacks.AudioLogger",
    "main.ImageLogger": "versband_tpu.train.callbacks.ImageLogger",
    "main.SpectrogramDataModuleFromConfig": "versband_tpu.data.datamodule.SpectrogramDataModule",
    "main.DataModuleFromConfig": "versband_tpu.data.datamodule.DataModule",
}

class Config(dict):
    """Nested dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj


class Identity:
    """Stand-in for ``torch.nn.Identity`` loss placeholders in configs (the
    reference YAML's ``lossconfig``)."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


def resolve_target(string: str) -> str:
    """Map a reference or JAX-package target onto this package's dotted path."""
    string = TARGET_ALIASES.get(string, string)
    if string.startswith(_JAX_PKG):
        string = _PORT_PKG + string[len(_JAX_PKG):]
    return string


def get_obj_from_str(string: str) -> Any:
    module, cls = resolve_target(string).rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


def instantiate_from_config(config: Mapping, **extra_kwargs: Any) -> Any:
    """Build the object described by ``{"target": ..., "params": {...}}``."""
    if "target" not in config:
        if config.get("__is_first_stage__", False) or config.get("__is_unconditional__", False):
            return None
        raise KeyError(f"Expected key `target` to instantiate: {config!r}")
    params = dict(config.get("params") or {})
    params.update(extra_kwargs)
    return get_obj_from_str(config["target"])(**params)


def load_config(path: str | os.PathLike) -> Config:
    """Load one YAML file, following ``base_config`` inheritance parent-first."""
    path = os.fspath(path)
    cfg = yaml_subset.load(path) or {}
    bases = cfg.pop("base_config", None)
    if bases:
        if isinstance(bases, str):
            bases = [bases]
        merged: dict = {}
        for base in bases:
            cand = base
            if not os.path.exists(cand):
                cand = os.path.join(os.path.dirname(path), base)
            merged = merge_configs(merged, load_config(cand))
        cfg = merge_configs(merged, cfg)
    return Config.wrap(cfg)


def merge_configs(base: Mapping, override: Mapping) -> Config:
    """Deep-merge ``override`` into ``base`` (override wins; dicts merge)."""
    out = dict(copy.deepcopy(dict(base)))
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = merge_configs(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return Config.wrap(out)


def apply_dot_overrides(cfg: Mapping, overrides: Iterable[str]) -> Config:
    """Apply ``a.b.c=value`` overrides; values are parsed as YAML (flow
    collections included); a value that does not parse stays a string."""

    def parse(s: str) -> Any:
        try:
            return yaml_subset.loads(s)
        except yaml_subset.YAMLSubsetError:
            return s

    cfg = Config.wrap(copy.deepcopy(dict(cfg)))
    for item in overrides:
        if not item:
            continue
        key, _, raw = item.partition("=")
        node = cfg
        parts = key.lstrip("+-").split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Mapping):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = Config.wrap(parse(raw))
    return cfg


def config_to_yaml(cfg: Mapping) -> str:
    """YAML text of a config tree (the counterpart of the JAX package's
    ``config_to_yaml``, written without PyYAML): ``yaml.safe_load`` of it
    equals ``yaml.safe_load`` of the JAX text, and :func:`load_config` reads
    it back equal."""
    return yaml_subset.dumps(cfg)
