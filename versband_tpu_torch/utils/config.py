"""Config trees, dotted overrides and instantiation from ``target`` strings.

The port's own copy of ``load_config``, ``merge_configs`` and
``apply_dot_overrides`` (reference: ``versband_tpu/utils/config.py``). Target
strings of the reference repo (``ldm.*``, ``vocoder.*``) and of the JAX package
(``versband_tpu.*``) resolve to this package, so ``configs/vocal2music.yaml``
builds the port unchanged. ``yaml`` is imported only where YAML is parsed.
"""

from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Iterable, Mapping

_JAX_PKG = "versband_tpu."
_PORT_PKG = "versband_tpu_torch."

# Reference dotted targets -> the JAX package's names; those are then mapped
# onto this package by prefix.
TARGET_ALIASES = {
    "ldm.models.autoencoder1d.AutoencoderKL": "versband_tpu.models.autoencoder.AutoencoderKL",
    "ldm.models.diffusion.cfm1_audio.CFM": "versband_tpu.models.cfm.CFM",
    "ldm.models.diffusion.ddpm_audio.LatentDiffusion_audio": "versband_tpu.models.cfm.LatentDiffusion",
    "ldm.models.diffusion.ddpm.LatentDiffusion": "versband_tpu.models.cfm.LatentDiffusion",
    "ldm.modules.diffusionmodules.vocal2music_moe.TxtFlagLargeImprovedDiTV2": "versband_tpu.models.dit.BandMoeDiT",
    "ldm.modules.diffusionmodules.vocal2music_moe.TxtFlagLargeDiT": "versband_tpu.models.dit.BandMoeDiT",
    "vocoder.hifigan.hifigan.HifiGAN": "versband_tpu.vocoder.hifigan.HifiGAN",
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
    import yaml

    path = os.fspath(path)
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
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
    """Apply ``a.b.c=value`` overrides; values are parsed as YAML scalars."""
    import yaml

    def parse(s: str) -> Any:
        try:
            return yaml.safe_load(s)
        except yaml.YAMLError:
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
