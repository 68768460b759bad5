"""The port's bf16 serving held to the JAX package's bf16 composition (CPU).

The JAX package serves as ``bench.py`` builds it: ``BandMoeDiT``,
``AutoencoderKL`` and ``HifiGanGenerator`` with ``dtype=bfloat16`` over
float32 params, ``euler_cfg_sample(..., encode_once=True)`` at CFG 2.0 from
start noise drawn in bf16, and a decode of ``z.astype(bf16)``. The port
serves ``CFM(dtype=torch.bfloat16)``, whose DiT and VAE round where flax
rounds op by op (``versband_tpu_torch/nn/rounding.py``), and the bf16
``HifiGAN`` wrapper, whose convs are torch's.
Weights go port -> JAX through the JAX converter; inputs are made with numpy
from a seed and handed to both packages.

Every gap is a relative L2, ``||a - b|| / ||b||``: ``g_jax`` JAX bf16 against
JAX fp32, ``g_port`` port bf16 against port fp32, ``g_cross`` port bf16
against JAX bf16. Bars: ``g_port <= 1.5 g_jax`` and ``g_cross <= g_jax``,
per module with one input fed to both dtypes, and for the composed slice
(sampler, decode, vocode). Each test prints its gaps (``pytest -s``).

The ``slow`` case measures the JAX package's own gaps at the shipped width
on ``chip_smoke.py``'s ``[bf16-serve]`` inputs; the card's bars are 1.5x
those, kept in ``chip_smoke.py`` as ``BF16_JAX_GAPS``.
"""

import copy
import importlib.util
import math
import time
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from versband_tpu.models.autoencoder import AutoencoderKL as JVAE
from versband_tpu.models.cfm import euler_cfg_sample as j_euler
from versband_tpu.models.dit import BandMoeDiT as JDiT
from versband_tpu.vocoder.hifigan import HifiGanGenerator as JGen
from versband_tpu_torch.models.cfm import CFM, CFMSampler
from versband_tpu_torch.nn import rounding
from versband_tpu_torch.nn.core import RMSNorm
from versband_tpu_torch.vocoder.hifigan import HifiGAN, HifiGanGenerator
from torch_port_helpers import (
    BEATS_V, DIT_TINY, MIDI_V, VAE_TINY, VOC_TINY, perturb_zero_init, to_jax)

REPO = Path(__file__).resolve().parents[1]
BF = torch.bfloat16
DIT_KW = dict(DIT_TINY, use_flash=True)  # the shipped config routes self-attention to K1
B, T_MEL, STEPS, CFG = 1, 16, 3, 2.0


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def f32(x) -> np.ndarray:
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(jnp.asarray(x, jnp.float32))


def bf16_values(x) -> np.ndarray:
    """``x`` rounded to bf16, as float32 (one input for both dtypes)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF).float().numpy()


def gaps(port16, port32, jax16, jax32) -> dict:
    return dict(g_jax=rel(f32(jax16), f32(jax32)), g_port=rel(f32(port16), f32(port32)),
                g_cross=rel(f32(port16), f32(jax16)))


def perturb_norms(module: nn.Module, seed: int, std: float = 0.3) -> None:
    """Norm scales and biases away from 1 and 0, so that their float32
    casting shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.LayerNorm, nn.GroupNorm, RMSNorm)):
                for p in m.parameters(recurse=False):
                    p.add_(torch.randn(p.shape, generator=g) * std)


# ---------------------------------------------------------------------------
# the pieces of nn/rounding.py, op by op against flax / jax.nn in bf16

def _conv_params(w, b):
    return {"params": {"kernel": jnp.asarray(w.numpy().transpose(2, 1, 0)),
                       "bias": jnp.asarray(b.numpy())}}


def _piece(name, x):
    """(the port's piece, flax's function of a feature-last bf16 array, the
    plain torch op) for piece ``name`` on ``x`` [B, C, T]."""
    g = torch.Generator().manual_seed(1)
    C = x.shape[1]
    w, b = torch.randn(C, C, 3, generator=g) * 0.2, torch.randn(C, generator=g)
    scale, shift = 1 + 0.3 * torch.randn(C, generator=g), 0.3 * torch.randn(C, generator=g)
    bf = jnp.bfloat16
    affine = {"params": {"scale": jnp.asarray(scale.numpy()), "bias": jnp.asarray(shift.numpy())}}

    def last(f):  # a [B, C, T] function applied feature-last
        return lambda v: f(v.transpose(1, 2)).transpose(1, 2)

    if name == "sigmoid":
        return rounding.sigmoid, jax.nn.sigmoid, torch.sigmoid
    if name == "silu":
        return rounding.silu, fnn.silu, F.silu
    if name == "gelu":
        return rounding.gelu, lambda v: fnn.gelu(v, approximate=False), F.gelu
    if name == "softmax":
        return (rounding.softmax, lambda v: jax.nn.softmax(v, axis=-1),
                lambda v: torch.softmax(v, -1))
    if name == "leaky_relu":
        return (lambda v: rounding.leaky_relu(v, 0.1), lambda v: fnn.leaky_relu(v, 0.1),
                lambda v: F.leaky_relu(v, 0.1))
    if name == "linear":
        lin = rounding.Linear(C, C)
        lin.weight.data, lin.bias.data = w[..., 0].clone(), b.clone()
        p = {"params": {"kernel": jnp.asarray(w[..., 0].numpy().T), "bias": jnp.asarray(b.numpy())}}
        return (last(lambda v: _cast(lin, v.dtype)(v)),
                lambda v: fnn.Dense(C, dtype=bf).apply(p, v), last(lambda v: F.linear(v, lin.weight, b)))
    if name == "conv1d":
        conv = rounding.Conv1d(C, C, 3, padding=1)
        conv.weight.data, conv.bias.data = w.clone(), b.clone()
        return (lambda v: _cast(conv, v.dtype)(v),
                lambda v: fnn.Conv(C, (3,), padding="SAME", dtype=bf).apply(_conv_params(w, b), v),
                lambda v: F.conv1d(v, w, b, padding=1))
    if name == "layer_norm":
        ln = rounding.LayerNorm(C, eps=1e-6)
        ln.weight.data, ln.bias.data = scale.clone(), shift.clone()
        return (last(lambda v: _cast(ln, v.dtype)(v)),
                lambda v: fnn.LayerNorm(epsilon=1e-6, dtype=bf).apply(affine, v),
                last(lambda v: F.layer_norm(v, (C,), scale, shift, 1e-6)))
    if name == "group_norm":
        gn = rounding.GroupNorm(8, C, eps=1e-6)
        gn.weight.data, gn.bias.data = scale.clone(), shift.clone()
        return (lambda v: _cast(gn, v.dtype)(v),
                lambda v: fnn.GroupNorm(num_groups=8, epsilon=1e-6, dtype=bf).apply(affine, v),
                lambda v: F.group_norm(v, 8, scale, shift, 1e-6))
    raise KeyError(name)


def _cast(module, dtype):
    return rounding.cast_module(copy.deepcopy(module), dtype)


PIECES = ["sigmoid", "silu", "gelu", "softmax", "leaky_relu", "linear", "conv1d",
          "layer_norm", "group_norm"]


ELEMENTWISE = {"sigmoid", "silu", "gelu", "softmax", "leaky_relu"}


@pytest.mark.parametrize("name", PIECES)
def test_rounding_pieces_are_jax_in_bf16_and_torch_in_fp32(name):
    """bf16: bit for bit what the flax function gives op by op; float32: the
    plain torch op."""
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 16, 24).astype(np.float32) * 2)
    port, flax_fn, plain = _piece(name, x)
    jx = jnp.asarray(x.numpy(), jnp.bfloat16)
    if name in ELEMENTWISE:
        ref = flax_fn(jx)
    else:
        ref = jnp.swapaxes(flax_fn(jnp.swapaxes(jx, 1, 2)), 1, 2)
    got = port(x.to(BF))
    assert got.dtype == BF
    np.testing.assert_array_equal(f32(got), f32(ref))
    np.testing.assert_allclose(f32(port(x)), f32(plain(x)), rtol=1e-6, atol=1e-6)


def test_cast_module_keeps_what_flax_keeps_in_float32():
    torch.manual_seed(0)
    cfm = CFM(unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT", params=DIT_TINY),
              first_stage_config=dict(target="ldm.models.autoencoder1d.AutoencoderKL",
                                      params=VAE_TINY),
              mel_dim=4, device="cpu", dtype=BF)
    kept = {type(m).__name__ + "." + n for module in (cfm.model, cfm.first_stage)
            for m in module.modules() for n, p in m.named_parameters(recurse=False)
            if p.dtype == torch.float32}
    assert kept == {"LayerNorm.weight", "LayerNorm.bias", "GroupNorm.weight", "GroupNorm.bias",
                    "JointAttention.gate"}
    others = [p for p in cfm.model.parameters() if p.dtype != torch.float32]
    assert others and all(p.dtype == BF for p in others)


_CONCAT = dict(in_channels=4, context_dim=12, hidden_size=32, depth=2, num_heads=2, max_len=64)
_DD2 = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8], in_channels=1,
            resolution=16, z_channels=4, out_ch=1, double_z=True)
# tiny arguments for every backbone and first stage the alias table names
TINY_MODULES = {
    "BandMoeDiT": DIT_TINY,
    "TimeFreqMoeDiT": dict(in_channels=4, context_dim=12, hidden_size=16, depth=2, num_heads=2,
                           max_len=32, num_experts=4, multiple_of=8),
    "ConcatDiT": _CONCAT, "ConcatDiT2MLP": _CONCAT, "HybridDiT2MLP": _CONCAT,
    "HybridDiT2MLP2": _CONCAT, "ConcatOrderDiT": _CONCAT, "ConcatOrderDiT2": _CONCAT,
    "AutoencoderKL": VAE_TINY,
    "AutoencoderKL2D": dict(embed_dim=3, ddconfig=_DD2),
    "VQModel": dict(embed_dim=3, n_embed=8, ddconfig=_DD2),
    "VQModelInterface": dict(embed_dim=3, n_embed=8, ddconfig=_DD2),
    "IdentityFirstStage": {},
    "NoiseLevelClassifier": dict(num_classes=3, in_channels=2, hidden=16, depth=2),
}


def _model_targets() -> dict:
    """The alias table's targets that are modules of the port's ``models``
    package (what ``LatentDiffusion._build`` builds and casts), by class name."""
    from versband_tpu_torch.utils.config import TARGET_ALIASES, get_obj_from_str

    out = {}
    for alias in TARGET_ALIASES:
        cls = get_obj_from_str(alias)
        if isinstance(cls, type) and issubclass(cls, nn.Module) and \
                cls.__module__.startswith("versband_tpu_torch.models."):
            out.setdefault(cls.__name__, alias)
    return out


def test_tiny_modules_cover_the_alias_tables_models():
    assert set(_model_targets()) == set(TINY_MODULES)


@pytest.mark.parametrize("name", sorted(TINY_MODULES))
def test_cast_module_casts_torchs_own_norms(name):
    """torch's ``nn.LayerNorm`` / ``nn.GroupNorm`` take parameters of their
    input's type (the card refuses float32 ones with bf16 input), so only
    ``nn/rounding.py``'s norms and the ``fp32_params`` a module names stay
    float32; the older backbones keep torch's norms."""
    from versband_tpu_torch.utils.config import instantiate_from_config

    torch.manual_seed(0)
    m = instantiate_from_config({"target": _model_targets()[name], "params": TINY_MODULES[name]})
    rounding.cast_module(m, BF)
    for sub in m.modules():
        mine = isinstance(sub, (rounding.LayerNorm, rounding.GroupNorm))
        for n, p in sub.named_parameters(recurse=False):
            if not p.is_floating_point():
                continue
            want = torch.float32 if mine or n in getattr(sub, "fp32_params", ()) else BF
            assert p.dtype == want, (type(sub).__name__, n, p.dtype)


# ---------------------------------------------------------------------------
# the modules and the composed slice

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Port fp32 and bf16 models on one set of weights, their JAX params, and
    the conditioning of one request."""
    unet = dict(target="versband_tpu.models.dit.BandMoeDiT", params=DIT_KW)
    vae = dict(target="ldm.models.autoencoder1d.AutoencoderKL", params=VAE_TINY)
    torch.manual_seed(0)
    cfm32 = CFM(unet_config=unet, first_stage_config=vae, mel_dim=4, scale_factor=1.0,
                device="cpu")
    perturb_zero_init(cfm32.model, 0)
    perturb_norms(cfm32.model, 1)
    perturb_norms(cfm32.first_stage, 2)
    torch.manual_seed(3)
    voc32 = HifiGanGenerator(**VOC_TINY).eval()
    cfm16 = CFM(unet_config=unet, first_stage_config=vae, mel_dim=4, scale_factor=1.0,
                device="cpu", dtype=BF)
    cfm16.model.load_state_dict(cfm32.model.state_dict())
    cfm16.first_stage.load_state_dict(cfm32.first_stage.state_dict())
    voc_dir = tmp_path_factory.mktemp("hifigan")
    torch.save(voc32.state_dict(), voc_dir / "generator.pt")
    voc16 = HifiGAN(str(voc_dir), device="cpu", dtype=BF, **VOC_TINY)

    rng = np.random.RandomState(7)
    midi = rng.randint(0, MIDI_V, (B, 1, T_MEL))
    beats = rng.randint(0, BEATS_V, (B, 1, T_MEL))
    cap = bf16_values(rng.randn(B, 5, DIT_TINY["ori_dim"]))
    z0 = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (B, 4, T_MEL // 2), jnp.bfloat16))
    return dict(cfm32=cfm32, cfm16=cfm16, voc32=voc32, voc16=voc16,
                jdit=to_jax(cfm32.model, "dit"), jvae=to_jax(cfm32.first_stage, "vae"),
                jvoc=to_jax(voc32, "hifigan", num_resblock_kernels=2),
                midi=midi, beats=beats, cap=cap, z0=f32(z0))


def _cond(s, lib, dtype, uncond=False):
    cap = np.zeros_like(s["cap"]) if uncond else s["cap"]
    midi = np.full_like(s["midi"], 128) if uncond else s["midi"]
    beats = np.full_like(s["beats"], 2) if uncond else s["beats"]
    if lib is torch:
        return {"caption": torch.from_numpy(cap).to(dtype),
                "acoustic": {"midi": torch.from_numpy(midi), "beats": torch.from_numpy(beats)}}
    return {"caption": jnp.asarray(cap, dtype),
            "acoustic": {"midi": jnp.asarray(midi), "beats": jnp.asarray(beats)}}


def _ctx(cond_t, cond_j):
    """The CFG-doubled contexts (cond then uncond), port and JAX."""
    from versband_tpu.models.cfm import _cond_to_context as jctx, _tree_concat as jcat
    from versband_tpu_torch.models.cfm import _cond_to_context as tctx, _tree_concat as tcat

    return tcat(tctx(cond_t[0]), tctx(cond_t[1])), jcat(jctx(cond_j[0]), jctx(cond_j[1]))


def _jax_decode(dt, jit=False):
    fn = lambda p, z: JVAE(**VAE_TINY, dtype=dt).apply(p, z, method="decode")  # noqa: E731
    return jax.jit(fn) if jit else fn


def _jax_vocode(dt):
    return JGen(**VOC_TINY, use_weight_norm=False, dtype=dt).apply


@pytest.fixture(scope="module")
def stage_gaps(served):
    """Each module's gaps, one input fed to both dtypes in both packages."""
    s, out = served, {}
    jdit = {dt: JDiT(**DIT_KW, dtype=dt) for dt in (jnp.float32, jnp.bfloat16)}
    n = 2 * B
    enc = {}
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF)):
        ctx_t, ctx_j = _ctx([_cond(s, torch, tdt), _cond(s, torch, tdt, True)],
                            [_cond(s, jnp, dt), _cond(s, jnp, dt, True)])
        model = s["cfm32"].model if tdt == torch.float32 else s["cfm16"].model
        with torch.no_grad():
            tenc = model(None, None, {**ctx_t, "encode_only": True})
        jenc = jdit[dt].apply(s["jdit"], jnp.zeros((n, 4, T_MEL // 2), dt),
                              jnp.zeros((n,), jnp.float32), {**ctx_j, "encode_only": True})
        enc[tdt] = (tenc, jenc)
    for k in ("acoustic", "caption", "cap_emb"):
        out[f"dit_encode_{k}"] = gaps(enc[BF][0][k], enc[torch.float32][0][k], enc[BF][1][k],
                                      enc[torch.float32][1][k])

    # one step: the same encodings, latent and timestep in both dtypes
    x = bf16_values(np.random.RandomState(8).randn(n, 4, T_MEL // 2))
    t = np.full((n,), 480.0, np.float32)
    encoded = {k: bf16_values(f32(v)) for k, v in enc[torch.float32][1].items()}
    step = {}
    for dt, tdt, model in ((jnp.float32, torch.float32, s["cfm32"].model),
                           (jnp.bfloat16, BF, s["cfm16"].model)):
        with torch.no_grad():
            tv, _ = model(torch.from_numpy(x).to(tdt), torch.from_numpy(t),
                          {"c_encoded": {k: torch.from_numpy(v).to(tdt)
                                         for k, v in encoded.items()}})
        jv, _ = jdit[dt].apply(s["jdit"], jnp.asarray(x, dt), jnp.asarray(t),
                               {"c_encoded": {k: jnp.asarray(v, dt) for k, v in encoded.items()}})
        step[tdt] = (tv, jv)
    out["dit_step"] = gaps(step[BF][0], step[torch.float32][0], step[BF][1],
                           step[torch.float32][1])

    z = bf16_values(np.random.RandomState(9).randn(B, 4, T_MEL // 2))
    dec = {}
    for dt, tdt, cfm in ((jnp.float32, torch.float32, s["cfm32"]),
                         (jnp.bfloat16, BF, s["cfm16"])):
        tm = cfm.decode_first_stage(torch.from_numpy(z).to(tdt))
        jm = _jax_decode(dt)(s["jvae"], jnp.asarray(z, dt))
        dec[tdt] = (tm, jm)
    out["vae_decode"] = gaps(dec[BF][0], dec[torch.float32][0], dec[BF][1],
                             dec[torch.float32][1])

    mel = bf16_values(f32(dec[torch.float32][1]))
    with torch.no_grad():
        w32 = s["voc32"](torch.from_numpy(mel))
    w16 = s["voc16"].waveform(torch.from_numpy(mel).to(BF))
    jw = {dt: _jax_vocode(dt)(s["jvoc"], jnp.asarray(mel, dt)) for dt in (jnp.float32, jnp.bfloat16)}
    out["hifigan"] = gaps(w16, w32, jw[jnp.bfloat16], jw[jnp.float32])
    return out


@pytest.mark.parametrize("stage", ["dit_encode_acoustic", "dit_encode_caption",
                                   "dit_encode_cap_emb", "dit_step", "vae_decode", "hifigan"])
def test_module_gaps(stage_gaps, stage):
    g = stage_gaps[stage]
    print(f"[bf16] {stage}: " + ", ".join(f"{k} {v:.3e}" for k, v in g.items()))
    assert g["g_jax"] > 1e-4  # the bf16 path really rounds
    assert g["g_port"] <= 1.5 * g["g_jax"], g
    assert g["g_cross"] <= g["g_jax"], g


def _jax_slice(s, dt):
    """bench.py's composition at tiny widths, op by op (``jax.disable_jit``
    runs the sampler's scan as a loop): encode-once CFG sampling from bf16
    start noise, the decode of ``z.astype(dt)``, HiFi-GAN."""
    with jax.disable_jit():
        z = j_euler(JDiT(**DIT_KW, dtype=dt).apply, s["jdit"], jnp.asarray(s["z0"], dt),
                    _cond(s, jnp, dt), _cond(s, jnp, dt, True), guidance_scale=CFG,
                    num_steps=STEPS, encode_once=True)
    mel = JVAE(**VAE_TINY, dtype=dt).apply(s["jvae"], z.astype(dt), method="decode")
    return z, mel, JGen(**VOC_TINY, use_weight_norm=False, dtype=dt).apply(s["jvoc"], mel)


def _port_slice(s, tdt):
    """The port's serving entry points: ``CFMSampler.sample_cfg`` from the
    same start noise, ``decode_first_stage`` and the vocoder."""
    cfm = s["cfm32"] if tdt == torch.float32 else s["cfm16"]
    z = CFMSampler(cfm, STEPS).sample_cfg(_cond(s, torch, tdt), CFG, _cond(s, torch, tdt, True),
                                          x_latent=torch.from_numpy(s["z0"]).to(tdt))
    mel = cfm.decode_first_stage(z)
    if tdt == torch.float32:
        with torch.no_grad():
            return z, mel, s["voc32"](mel)
    return z, mel, s["voc16"].waveform(mel)


@pytest.fixture(scope="module")
def slice_gaps(served):
    jb, j32 = _jax_slice(served, jnp.bfloat16), _jax_slice(served, jnp.float32)
    pb, p32 = _port_slice(served, BF), _port_slice(served, torch.float32)
    assert pb[0].dtype == pb[1].dtype == pb[2].dtype == BF
    assert jb[2].dtype == jnp.bfloat16
    assert rel(f32(j32[0]), served["z0"]) > 1e-2  # the field moved the latent
    return {name: gaps(pb[i], p32[i], jb[i], j32[i])
            for i, name in enumerate(("latent", "mel", "waveform"))}


@pytest.mark.parametrize("stage", ["latent", "mel", "waveform"])
def test_composed_slice_gaps(slice_gaps, stage):
    g = slice_gaps[stage]
    print(f"[bf16] slice {stage}: " + ", ".join(f"{k} {v:.3e}" for k, v in g.items()))
    assert g["g_jax"] > 1e-4
    assert g["g_port"] <= 1.5 * g["g_jax"], g
    assert g["g_cross"] <= g["g_jax"], g


def test_compiled_vae_decode_leaves_its_op_by_op_rounding(served):
    """XLA's compiled program keeps some fused intermediates in float32 (in
    the decoder, a conv's biased output enters GroupNorm's normalisation
    unrounded while its statistics take the rounded value), and the tiny
    decoder's bf16 output moves by the order of its whole bf16 gap on any
    change of rounding: one bf16 ulp on one latent element does as much. So
    the jitted JAX decode is as far from the port as from the JAX package's
    own op-by-op composition, which the port equals bit for bit (ROADMAP
    Queue 3)."""
    s = served
    z = bf16_values(np.random.RandomState(9).randn(B, 4, T_MEL // 2))
    jit16 = f32(_jax_decode(jnp.bfloat16, jit=True)(s["jvae"], jnp.asarray(z, jnp.bfloat16)))
    jit32 = f32(_jax_decode(jnp.float32, jit=True)(s["jvae"], jnp.asarray(z)))
    eager16 = f32(_jax_decode(jnp.bfloat16)(s["jvae"], jnp.asarray(z, jnp.bfloat16)))
    port16 = f32(s["cfm16"].decode_first_stage(torch.from_numpy(z).to(BF)))
    z1 = z.copy()
    z1.flat[5] = f32(torch.nextafter(torch.tensor(z.flat[5]).to(BF), torch.tensor(9.0).to(BF)))
    moved16 = f32(_jax_decode(jnp.bfloat16)(s["jvae"], jnp.asarray(z1, jnp.bfloat16)))
    moved32 = f32(_jax_decode(jnp.float32)(s["jvae"], jnp.asarray(z1)))
    g_jit, g_self = rel(jit16, jit32), rel(eager16, jit16)
    g_ulp16, g_ulp32 = rel(moved16, eager16), rel(moved32, jit32)
    print(f"[bf16] vae_decode compiled: g_jax {g_jit:.3e}, op-by-op JAX vs compiled {g_self:.3e}, "
          f"port vs compiled {rel(port16, jit16):.3e}; one ulp of one latent moves bf16 by "
          f"{g_ulp16:.3e}, fp32 by {g_ulp32:.3e}")
    np.testing.assert_array_equal(port16, eager16)
    assert g_self >= 0.5 * g_jit and g_ulp16 >= 0.5 * g_jit and g_ulp32 <= 0.2 * g_jit


# ---------------------------------------------------------------------------
# the card's bars: the JAX package's own gaps at the shipped width

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stages(sample, decode, vocode) -> dict:
    """``{stage: {"bf16": out, "fp32": out}}`` of one package at the shipped
    width, stage by stage with one input fed to both dtypes (the sampler from
    the start noise, the decode of the fp32 latent, the vocode of the fp32
    mel) and end to end; ``sample(dt)``, ``decode(dt, z)`` and
    ``vocode(dt, mel)`` take and give float32 numpy arrays."""
    z = {dt: sample(dt) for dt in ("bf16", "fp32")}
    mel = {dt: decode(dt, bf16_values(z["fp32"])) for dt in z}
    wav = {dt: vocode(dt, bf16_values(mel["fp32"])) for dt in z}
    end = {dt: vocode(dt, decode(dt, z[dt])) for dt in z}
    return {"latent": z, "mel": mel, "waveform": wav, "end_to_end": end}


def jax_full_width(cs, w) -> dict:
    """bench.py's jitted composition at the shipped width on ``w``
    (``chip_smoke.bf16_serve_inputs()``)."""
    jdit, jvae = to_jax(w["dit"], "dit"), to_jax(w["vae"], "vae")
    jvoc = to_jax(w["voc"], "hifigan", num_resblock_kernels=3)
    types = {"bf16": jnp.bfloat16, "fp32": jnp.float32}

    def cond(c, dt):
        return {"caption": jnp.asarray(f32(c["caption"]), dt),
                "acoustic": {k: jnp.asarray(v.numpy()) for k, v in c["acoustic"].items()}}

    def sample(dt):
        apply = JDiT(**cs.DIT, dtype=types[dt]).apply
        run = jax.jit(lambda p, z, c, u: j_euler(apply, p, z, c, u, guidance_scale=cs.CFG_SCALE,
                                                 num_steps=cs.STEPS, encode_once=True))
        return f32(run(jdit, jnp.asarray(f32(w["z0"]), types[dt]), cond(w["cond"], types[dt]),
                       cond(w["uncond"], types[dt])))

    def decode(dt, z):
        fn = jax.jit(lambda p, v: JVAE(**cs.VAE, dtype=types[dt]).apply(p, v, method="decode"))
        return f32(fn(jvae, jnp.asarray(z, types[dt])))

    def vocode(dt, mel):
        fn = jax.jit(JGen(dtype=types[dt], use_weight_norm=False).apply)
        return f32(fn(jvoc, jnp.asarray(mel, types[dt])))

    return _stages(sample, decode, vocode)


def port_full_width(cs, w) -> dict:
    """The port's serving path at the shipped width on ``w``, on the CPU."""
    types = {"bf16": BF, "fp32": torch.float32}
    cfm, voc = {}, {}
    for dt, tdt in types.items():
        cfm[dt] = CFM(unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT", params=cs.DIT),
                      first_stage_config=dict(
                          target="versband_tpu.models.autoencoder.AutoencoderKL", params=cs.VAE),
                      mel_dim=20, scale_factor=1.0, device="cpu", dtype=tdt)
        cfm[dt].model.load_state_dict(w["dit"].state_dict())
        cfm[dt].first_stage.load_state_dict(w["vae"].state_dict())
        voc[dt] = copy.deepcopy(w["voc"]).to(tdt)

    def tree(c, tdt):
        return {"caption": c["caption"].to(tdt), "acoustic": c["acoustic"]}

    def sample(dt):
        return f32(cfm[dt].sample_cfg(tree(w["cond"], types[dt]), cs.CFG_SCALE,
                                      tree(w["uncond"], types[dt]),
                                      x_latent=w["z0"].to(types[dt]), timesteps=cs.STEPS))

    def decode(dt, z):
        return f32(cfm[dt].decode_first_stage(torch.from_numpy(z).to(types[dt])))

    def vocode(dt, mel):
        with torch.no_grad():
            return f32(voc[dt](torch.from_numpy(mel).to(types[dt])))

    return _stages(sample, decode, vocode)


@pytest.mark.slow
def test_chip_smoke_bars_are_the_jax_packages_gaps_at_full_width():
    """Slow (~3 min, ~5 GiB): JAX's full-width bf16 and fp32 serving on the
    CPU, whose gaps must be chip_smoke.py's BF16_JAX_GAPS within 10 %; the
    port's own full-width gaps on the CPU, and its distance from the jitted
    JAX program, are printed beside them."""
    cs = _chip_smoke()
    w = cs.bf16_serve_inputs()
    t0 = time.perf_counter()
    jx = jax_full_width(cs, w)
    got = {k: rel(v["bf16"], v["fp32"]) for k, v in jx.items()}
    print(f"[bf16] JAX full-width gaps {got} in {time.perf_counter() - t0:.0f} s")
    pt = port_full_width(cs, w)
    for k in pt:
        print(f"[bf16] port full width {k}: g_port {rel(pt[k]['bf16'], pt[k]['fp32']):.4e}, "
              f"against jitted JAX bf16 {rel(pt[k]['bf16'], jx[k]['bf16']):.4e}")
    for stage, gap in got.items():
        want = cs.BF16_JAX_GAPS[stage]
        assert math.isclose(gap, want, rel_tol=0.1), (stage, gap, want)
    assert got["end_to_end"] > cs.BF16_E2E_OVER_WAVEFORM * got["waveform"], got
