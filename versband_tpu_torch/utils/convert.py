"""JAX params -> the port's state_dict: weights carried across.

``state_dict_from_jax(params, family)`` takes a flax param tree of
``versband_tpu`` (nested dicts of arrays, optionally under ``"params"``) for
``family`` in :data:`FAMILIES` and returns a state_dict that loads into the
matching port module. It inverts the JAX package's torch -> flax converter
without importing it:

* Dense kernels ``[in, out]`` -> ``[out, in]``; Conv ``[k, in, out]`` ->
  ``[out, in, k]``; ConvTranspose ``[k, in, out]`` -> ``[in, out, k]``;
* ``scale`` and ``embedding`` -> ``weight``;
* stacked experts ``[E, d, h]`` -> ``{grp}_experts.{e}.w{n}.weight`` (the
  Band-MoE's caption/acoustic/freq groups and the Time/Freq MoE's
  time/freq groups alike);
* the 2-D KL and VQ autoencoders under ``vae`` (2-D kernels ``(kh, kw, in,
  out)`` -> ``[out, in, kh, kw]``; the codebook ``quantize/embedding`` ->
  ``quantize.embedding.weight``);
* ``concat_dit``: ``{c,c1,c2,caption}_embedder/ln`` -> ``mlp.3``,
  ``blocks_{i}/transformer_blocks_{j}`` -> ``blocks.{i}.transformer_blocks.{j}``,
  ``to_out`` -> ``to_out.0``, ``ff/proj`` / ``ff/out`` -> ``ff.net.0.proj`` /
  ``ff.net.2``, ``code_proj`` -> ``code_proj.0``;
* caption cross-attention ``wq/wk/wv`` -> packed ``in_proj_weight/bias``;
* ``resblocks_{i}_{j}`` -> ``resblocks.{i*K+j}``;
* BigVGAN: ``ups_{i}`` -> ``ups.{i}.0`` (transposed conv), ``acts1_{n}`` /
  ``acts2_{n}`` -> ``activations.{2n}`` / ``{2n+1}.act`` (AMPBlock1),
  ``acts_{n}`` -> ``activations.{n}.act`` (AMPBlock2), ``activation_post`` ->
  ``activation_post.act``;
* PWG: ``conv_layers_{i}`` -> ``conv_layers.{i}``, ``last_conv_{0,1}`` ->
  ``last_conv_layers.{1,3}``, the upsampler's ``conv_{j}`` ``(2s+1, fk, 1,
  1)`` -> ``upsample_net.upsample.up_layers.{2j+1}.weight`` ``[1, 1, fk,
  2s+1]``;
* T5 (``transformers``' Flax encoder tree, ``shared/embedding``,
  ``encoder/block/{i}/layer/{j}/...``): the paths are already Hugging Face's
  names, so only the kernels are transposed;
* ``kernel_v``/``kernel_g`` folded with the JAX convention (per output
  channel), or, with ``weight_norm=True`` (the default of the discriminator
  families), kept as ``weight_v``/``weight_g`` for the port's trainable form,
  g shaped ``[C_out, 1, ...]`` (``[1, C_out, 1]`` for a transposed conv);
* NSF: the HiFi-GAN names plus ``m_source.l_linear`` and ``noise_convs.{i}``;
  ``code_hifigan``: ``code_embed`` and the HiFi-GAN names under
  ``generator.``;
* MPD / MSD / MRD: ``disc_{i}/convs_{n}`` -> ``discriminators.{i}.convs.{n}``;
  MSD's spectral-normed ``disc_0`` kernels -> ``weight_orig``; ``mwd``:
  ``tower{i}_conv{j}`` / ``tower{i}_out`` -> ``towers.{i}.convs.{j}`` /
  ``towers.{i}.out`` (2-D kernels ``(kh, kw, in, out)`` -> ``[out, in, kh, kw]``);
* ``pwg_disc``: ``conv_{i}`` -> ``conv_layers.{2i}``, ``conv_out`` -> the last;
  ``melgan``: the reference's flat ``melgan.{n}`` indices (``stack_{i}_{j}``'s
  ``conv_dilated`` / ``conv_1x1`` / ``shortcut`` -> ``stack.2`` / ``stack.4``
  / ``skip_layer``); ``melgan_disc``: ``disc_{i}/conv_in``, ``down_{n}``,
  ``conv_mid``, ``conv_out`` -> ``discriminators.{i}.layers.{0.1, n+1.0,
  D+1.0, D+2}``;
* the VAE-GAN loss module (``vaegan_loss``: ``logvar`` and the PatchGAN, its
  ``batch_stats`` beside its ``params``): NHWC conv kernels ``(kh, kw, in,
  out)`` -> ``[out, in, kh, kw]``; ``main_0`` -> ``discriminator.main.0``,
  ``main_n`` -> ``main.{3n-1}``, ``norm_n`` -> ``main.{3n}`` (BatchNorm
  ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/``running_mean``/
  ``running_var``; ActNorm ``loc``/``scale`` ``(C,)`` -> ``[1, C, 1, 1]``),
  ``main_out`` -> ``main.{3 n_layers + 2}``;
* CLAP (``clap``: the audio tower, both projections and ``logit_scale``;
  the BERT caption tower travels as a Hugging Face directory, see
  :func:`export_clap_bert`): each folded BatchNorm ``bn*_scale``/``bn*_bias``
  -> ``bn*.weight = scale * sqrt(1 + eps)``, ``bias``, ``running_mean`` 0,
  ``running_var`` 1, so that the eval-mode ``BatchNorm2d`` (eps 1e-5)
  computes the same affine; 2-D conv kernels ``(kh, kw, in, out)`` ->
  ``[out, in, kh, kw]``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from versband_tpu_torch.vocoder.conv import fold_weight_norm_jax

Repl = Union[str, Callable[[re.Match], str]]

_DIT_RULES: List[Tuple[str, Repl]] = [
    (r"^(midi|beats)_proj/conv/", r"\1_proj.0."),
    (r"^(t|c)_embedder/fc1/", r"\1_embedder.mlp.0."),
    (r"^(t|c)_embedder/fc2/", r"\1_embedder.mlp.2."),
    (r"^c_embedder/ln/", "c_embedder.norm."),
    (r"^cap_embedder_norm/", "cap_embedder.0."),
    (r"^cap_embedder/", "cap_embedder.1."),
    (r"^blocks_(\d+)/adaLN_modulation/", r"layers.\1.adaLN_modulation.1."),
    (r"^blocks_(\d+)/feed_forward/(caption|acoustic)_gate/",
     r"layers.\1.feed_forward.\2_gating_network."),
    (r"^blocks_(\d+)/feed_forward/high_level_gate/",
     r"layers.\1.feed_forward.high_level_gating_network."),
    (r"^blocks_(\d+)/feed_forward/cross_attention/wo/",
     r"layers.\1.feed_forward.cross_attention.out_proj."),
    (r"^blocks_(\d+)/", r"layers.\1."),
    (r"^final_layer/adaLN_modulation/", "final_layer.adaLN_modulation.1."),
]

_VAE_RULES: List[Tuple[str, Repl]] = [
    (r"^(encoder|decoder)/(down|up)_(\d+)_(block|attn)_(\d+)/", r"\1.\2.\3.\4.\5."),
    (r"^encoder/down_(\d+)_downsample/", r"encoder.down.\1.downsample."),
    (r"^decoder/up_(\d+)_upsample/", r"decoder.up.\1.upsample."),
    (r"^(encoder|decoder)/mid_(block_\d+|attn_\d+)/", r"\1.mid.\2."),
    (r"^quantize/embedding$", "quantize.embedding/embedding"),
]

_CONCAT_DIT_RULES: List[Tuple[str, Repl]] = [
    (r"^(t|c|c1|c2|caption)_embedder/fc1/", r"\1_embedder.mlp.0."),
    (r"^(t|c|c1|c2|caption)_embedder/fc2/", r"\1_embedder.mlp.2."),
    (r"^(c|c1|c2|caption)_embedder/ln/", r"\1_embedder.mlp.3."),
    (r"^code_proj/", "code_proj.0."),
    (r"^blocks_(\d+)/", r"blocks.\1."),
    (r"\btransformer_blocks_(\d+)/", r"transformer_blocks.\1."),
    (r"\bto_out/", "to_out.0."),
    (r"\bff/proj/", "ff.net.0.proj."),
    (r"\bff/out/", "ff.net.2."),
]


def _hifigan_rules(num_kernels: int) -> List[Tuple[str, Repl]]:
    return [
        (r"^ups_(\d+)/", r"ups.\1."),
        (r"^resblocks_(\d+)_(\d+)/",
         lambda m: f"resblocks.{int(m[1]) * num_kernels + int(m[2])}."),
        (r"(convs[12]?)_(\d+)/", r"\1.\2."),
    ]


def _bigvgan_rules(num_kernels: int) -> List[Tuple[str, Repl]]:
    return [
        (r"^ups_(\d+)/", r"ups.\1.0."),
        *_hifigan_rules(num_kernels)[1:],
        (r"\bacts1_(\d+)/", lambda m: f"activations.{2 * int(m[1])}.act."),
        (r"\bacts2_(\d+)/", lambda m: f"activations.{2 * int(m[1]) + 1}.act."),
        (r"\bacts_(\d+)/", r"activations.\1.act."),
        (r"^activation_post/", "activation_post.act/"),
    ]


_PWG_RULES: List[Tuple[str, Repl]] = [
    (r"^conv_layers_(\d+)/", r"conv_layers.\1."),
    (r"^last_conv_0/", "last_conv_layers.1."),
    (r"^last_conv_1/", "last_conv_layers.3."),
]


def _msd_rules() -> List[Tuple[str, Repl]]:
    return [(r"^disc_(\d+)/", r"discriminators.\1."), (r"\bconvs_(\d+)/", r"convs.\1.")]


_MWD_RULES: List[Tuple[str, Repl]] = [
    (r"^tower(\d+)_conv(\d+)/", r"towers.\1.convs.\2."),
    (r"^tower(\d+)_out/", r"towers.\1.out."),
]


def _count(flat, pattern: str) -> int:
    return len({m[1] for k in flat if (m := re.match(pattern, k))})


def _pwg_disc_rules(flat) -> List[Tuple[str, Repl]]:
    n = _count(flat, r"^conv_(\d+)/")
    return [(r"^conv_(\d+)/", lambda m: f"conv_layers.{2 * int(m[1])}."),
            (r"^conv_out/", f"conv_layers.{2 * n}.")]


def _melgan_rules(flat) -> List[Tuple[str, Repl]]:
    scales = _count(flat, r"^ups_(\d+)/")
    stacks = _count(flat, r"^stack_\d+_(\d+)/")

    def stack(m):
        return f"melgan.{2 + int(m[1]) * (2 + stacks) + 2 + int(m[2])}."
    return [(r"^conv_in/", "melgan.1."),
            (r"^ups_(\d+)/", lambda m: f"melgan.{2 + int(m[1]) * (2 + stacks) + 1}."),
            (r"^stack_(\d+)_(\d+)/", stack),
            (r"\bconv_dilated/", "stack.2."), (r"\bconv_1x1/", "stack.4."),
            (r"\bshortcut/", "skip_layer."),
            (r"^conv_out/", f"melgan.{2 + scales * (2 + stacks) + 2}.")]


def _melgan_disc_rules(flat) -> List[Tuple[str, Repl]]:
    n = _count(flat, r"^disc_\d+/down_(\d+)/")
    return [(r"^disc_(\d+)/", r"discriminators.\1.layers/"),
            (r"layers/conv_in/", "layers.0.1."),
            (r"layers/down_(\d+)/", lambda m: f"layers.{int(m[1]) + 1}.0."),
            (r"layers/conv_mid/", f"layers.{n + 1}.0."),
            (r"layers/conv_out/", f"layers.{n + 2}.")]


def _pwg_special(flat: Dict[str, np.ndarray], sd: Dict[str, np.ndarray]) -> None:
    """The upsampler's ``(2s+1, fk, 1, 1)`` stencils -> the reference's
    ``Conv2d`` weights ``[1, 1, fk, 2s+1]`` after each ``Stretch2d``
    (popped from ``flat``)."""
    for key in [k for k in flat if re.match(r"^upsample_net/upsample/conv_\d+$", k)]:
        j = int(key.rsplit("_", 1)[1])
        sd[f"upsample_net.upsample.up_layers.{2 * j + 1}.weight"] = \
            flat.pop(key).transpose(2, 3, 1, 0)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _fold(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for key, w in flat.items():
        if key.endswith("kernel_v"):
            out[key[:-2]] = fold_weight_norm_jax(w, flat[key[:-1] + "g"])
        elif not key.endswith("kernel_g"):
            out[key] = w
    return out


def _g_shape(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Each ``kernel_g (C_out,)`` reshaped to the rank of its ``kernel_v``
    (``(1, ..., 1, C_out)``), so that it transposes as the kernel does."""
    out = dict(flat)
    for key in flat:
        if key.endswith("kernel_g"):
            v = flat[key[:-1] + "v"]
            out[key] = flat[key].reshape((1,) * (v.ndim - 1) + (-1,))
    return out


def _rename(path: str, rules: List[Tuple[str, Repl]]) -> str:
    for pattern, repl in rules:
        path = re.sub(pattern, repl, path)
    return path.replace("/", ".")


def _leaf(key: str, w: np.ndarray, transposed: bool) -> Tuple[str, np.ndarray]:
    mod, _, leaf = key.rpartition(".")
    if leaf in ("kernel", "kernel_v", "kernel_g"):
        if w.ndim == 2:
            w = w.T
        elif w.ndim == 3:
            w = w.transpose(1, 2, 0) if transposed else w.transpose(2, 1, 0)
        elif w.ndim == 4:
            w = w.transpose(3, 2, 0, 1)
        leaf = "weight" + leaf[len("kernel"):]
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return f"{mod}.{leaf}", w


def _dit_special(flat: Dict[str, np.ndarray], sd: Dict[str, np.ndarray]) -> None:
    """Unstack experts and pack the cross-attention q/k/v (popped from ``flat``)."""
    for key in [k for k in flat if re.match(r"^blocks_\d+/feed_forward/\w+_experts/w\d$", k)]:
        w = flat.pop(key)  # [E, in, out]
        m = re.match(r"^blocks_(\d+)/feed_forward/(\w+_experts)/(w\d)$", key)
        for e in range(w.shape[0]):
            sd[f"layers.{m[1]}.feed_forward.{m[2]}.{e}.{m[3]}.weight"] = w[e].T
    for key in [k for k in flat if k.endswith("/cross_attention/wq/kernel")]:
        base = key[: -len("/wq/kernel")]
        blk = re.match(r"^blocks_(\d+)/", base)[1]
        dst = f"layers.{blk}.feed_forward.cross_attention"
        sd[f"{dst}.in_proj_weight"] = np.concatenate(
            [flat.pop(f"{base}/{n}/kernel").T for n in ("wq", "wk", "wv")], axis=0)
        sd[f"{dst}.in_proj_bias"] = np.concatenate(
            [flat.pop(f"{base}/{n}/bias") for n in ("wq", "wk", "wv")], axis=0)


def _vaegan_loss_state(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The ``VAEGANLoss`` state_dict of its flax variables (``params`` and
    ``batch_stats``)."""
    flat = _flatten(variables.get("params", variables))
    flat.update(_flatten(variables.get("batch_stats", {})))
    n_layers = max([int(m[1]) for k in flat if (m := re.match(r"discriminator/main_(\d+)/", k))]
                   or [0])
    actnorm = {k.rsplit("/", 1)[0] for k in flat if k.endswith("/loc")}
    sd = {}
    for path, w in flat.items():
        mod, _, leaf = path.rpartition("/")
        if path == "logvar":
            sd["logvar"] = w
            continue
        m = re.match(r"^discriminator/(main|norm)_(\d+|out)$", mod)
        if m is None:
            raise ValueError(f"unexpected VAEGANLoss variable {path!r}")
        kind, n = m[1], m[2]
        idx = 3 * n_layers + 2 if n == "out" else (0 if n == "0" else 3 * int(n) - (kind == "main"))
        if leaf == "kernel":
            leaf, w = "weight", w.transpose(3, 2, 0, 1)
        elif mod in actnorm:
            w = w.reshape(1, -1, 1, 1)
        else:
            leaf = {"scale": "weight", "mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
        sd[f"discriminator.main.{idx}.{leaf}"] = w
    return sd


BN_EPS = 1e-5  # nn.BatchNorm2d's, which the JAX converter folds with


def _clap_special(flat: Dict[str, np.ndarray], sd: Dict[str, np.ndarray]) -> None:
    """Unfold the BatchNorms and take ``logit_scale`` (popped from ``flat``)."""
    for key in [k for k in flat if re.search(r"bn\d_scale$", k)]:
        pre = key[: -len("_scale")].replace("/", ".")
        scale, bias = flat.pop(key), flat.pop(key[: -len("scale")] + "bias")
        sd[f"{pre}.weight"] = (scale * np.sqrt(np.float32(1) + np.float32(BN_EPS))).astype(
            scale.dtype)
        sd[f"{pre}.bias"] = bias
        sd[f"{pre}.running_mean"] = np.zeros_like(scale)
        sd[f"{pre}.running_var"] = np.ones_like(scale)
        sd[f"{pre}.num_batches_tracked"] = np.zeros((), np.int64)
    if "logit_scale" in flat:
        sd["logit_scale"] = np.asarray(flat.pop("logit_scale"), np.float32).reshape(())


GENERATORS = ("hifigan", "bigvgan", "pwg", "nsf", "code_hifigan", "melgan")
DISCRIMINATORS = ("mpd", "msd", "mrd", "mwd", "pwg_disc", "melgan_disc")
FAMILIES = ("dit", "vae", "concat_dit", "t5", "vaegan_loss", "clap") + GENERATORS + DISCRIMINATORS


def _num_kernels(flat) -> int:
    ks = [int(m[1]) for k in flat if (m := re.match(r"^(?:generator/)?resblocks_\d+_(\d+)/", k))]
    return 1 + max(ks) if ks else 1


def state_dict_from_jax(params: Dict[str, Any], family: str,
                        weight_norm: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a ``versband_tpu`` param tree of ``family``.
    ``weight_norm``: keep (v, g) pairs for the trainable form (default: only
    for the discriminator families)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; expected one of {', '.join(FAMILIES)}")
    if family == "vaegan_loss":
        return {k: torch.from_numpy(np.array(v)) for k, v in _vaegan_loss_state(params).items()}
    if weight_norm is None:
        weight_norm = family in DISCRIMINATORS
    tree = params.get("params", params)
    flat = _g_shape(_flatten(tree)) if weight_norm else _fold(_flatten(tree))
    sd: Dict[str, np.ndarray] = {}
    if family == "dit":
        _dit_special(flat, sd)
        rules = _DIT_RULES
    elif family == "vae":
        rules = _VAE_RULES
    elif family == "concat_dit":
        rules = _CONCAT_DIT_RULES
    elif family == "pwg":
        _pwg_special(flat, sd)
        rules = _PWG_RULES
    elif family in ("t5", "clap"):
        if family == "clap":
            _clap_special(flat, sd)
        rules = []
    elif family in ("mpd", "msd", "mrd"):
        rules = _msd_rules()
    elif family == "mwd":
        rules = _MWD_RULES
    elif family == "pwg_disc":
        rules = _pwg_disc_rules(flat)
    elif family == "melgan":
        rules = _melgan_rules(flat)
    elif family == "melgan_disc":
        rules = _melgan_disc_rules(flat)
    elif family == "bigvgan":
        rules = _bigvgan_rules(_num_kernels(flat))
    else:  # hifigan, nsf, code_hifigan
        rules = _hifigan_rules(_num_kernels(flat)) + [
            (r"^m_source/l_linear/", "m_source.l_linear."),
            (r"^noise_convs_(\d+)/", r"noise_convs.\1.")]
    for path, w in flat.items():
        transposed = family in GENERATORS and bool(re.search(r"(^|/)ups_\d+/", path))
        if family == "code_hifigan" and path.startswith("generator/"):
            name = "generator." + _rename(path[len("generator/"):], rules)
        else:
            name = _rename(path, rules)
        key, w = _leaf(name, w, transposed)
        if family == "msd" and key.startswith("discriminators.0.") and key.endswith(".weight"):
            key = key[: -len("weight")] + "weight_orig"  # the spectral-normed scale
        sd[key] = w
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def export_clap_bert(sd: Dict[str, Any], out_dir: str, tokenizer_src: Optional[str] = None
                     ) -> str:
    """The BERT caption tower of a reference CLAP state_dict
    (``caption_encoder.base.*``) as a Hugging Face directory: ``config.json``
    with the geometry read off the shapes (64-wide heads where the width
    allows, as JAX ``utils/torch_convert.py::export_clap_bert`` infers them)
    and ``model.safetensors``. The checkpoint holds no tokenizer: the
    ``tokenizer.json``/``vocab.txt`` of ``tokenizer_src`` is copied beside
    it, else a warning says the tower will hash words."""
    import json
    import os
    import shutil
    import warnings

    from versband_tpu_torch.utils.safetensors_io import save_safetensors

    prefix = "caption_encoder.base."
    tower = {k[len(prefix):]: torch.as_tensor(np.asarray(v)) for k, v in sd.items()
             if k.startswith(prefix) and not k.endswith(("position_ids", "token_type_ids"))}
    if not tower:
        raise ValueError("no caption_encoder.base.* keys in state dict")
    emb = tower["embeddings.word_embeddings.weight"]
    hidden = emb.shape[1]
    layers = 1 + max(int(m[1]) for k in tower if (m := re.match(r"encoder\.layer\.(\d+)\.", k)))
    heads = hidden // 64 if hidden % 64 == 0 else \
        (12 if hidden % 12 == 0 else max(1, hidden // 64))
    cfg = dict(architectures=["BertModel"], model_type="bert", hidden_size=int(hidden),
               vocab_size=int(emb.shape[0]), num_hidden_layers=int(layers),
               num_attention_heads=int(heads),
               intermediate_size=int(tower["encoder.layer.0.intermediate.dense.weight"].shape[0]),
               max_position_embeddings=int(tower["embeddings.position_embeddings.weight"].shape[0]),
               type_vocab_size=int(tower["embeddings.token_type_embeddings.weight"].shape[0]))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    save_safetensors(tower, os.path.join(out_dir, "model.safetensors"), {"format": "pt"})
    copied = [n for n in ("tokenizer.json", "vocab.txt", "tokenizer_config.json")
              if tokenizer_src and os.path.exists(os.path.join(tokenizer_src, n))]
    for n in copied:
        shutil.copy(os.path.join(tokenizer_src, n), os.path.join(out_dir, n))
    if not copied:
        warnings.warn(f"no tokenizer files exported to {out_dir}; place tokenizer.json or "
                      "vocab.txt there or caption tokenization will fall back to hashing",
                      stacklevel=2)
    return out_dir
