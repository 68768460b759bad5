"""The plain reference of AccompBand's serving path, in float32.

Functions of a weight dict (the reference checkpoints' key names, which the
port keeps) and plain ``torch`` operations: the FLAN-T5 encoder, the Band-MoE
DiT with its eval routing, the CFG Euler sampler, the 1-D KL-VAE decoder and
HiFi-GAN. Written from the published modules (the AccompBand reference,
arXiv:2504.19062) as ``versband_tpu`` describes them; nothing here imports
the program or JAX, and no kernel is used: attention is two ``einsum``s and
a softmax.

``Precision`` says how every matrix product and convolution is computed:
``fp32`` (TF32 off) is the reference; ``fp8`` rounds both operands to
float8 e4m3 with a per-tensor scale and multiplies in float32, which is the
control of the bfloat16 stages; ``tf32`` rounds both operands to TF32's 10
mantissa bits (to nearest) and multiplies in float32, as a TF32 tensor core
does, which is the control of the float32 caption tower.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


class Precision:
    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand as the products see it."""
        if self.mode == "fp32":
            return x
        if self.mode == "tf32":
            bits = x.float().contiguous().view(torch.int32)
            return ((bits + 0x1000) & -0x2000).view(torch.float32)
        scale = x.abs().amax().clamp_min(1e-30) / 448.0  # e4m3's largest finite
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b=None, **kw):
        return F.conv1d(self.q(x), self.q(w), b, **kw)

    def conv_t(self, x, w, b=None, **kw):
        return F.conv_transpose1d(self.q(x), self.q(w), b, **kw)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


def hash_ids(texts: Sequence[str], vocab_size: int, max_length: int) -> np.ndarray:
    """Token ids of the offline caption tower: md5 of each lower-cased
    whitespace word mod the vocabulary (2 reserved), an end token 1, pad 0."""
    ids = np.zeros((len(texts), max_length), np.int64)
    for i, t in enumerate(texts):
        words = t.lower().split()[: max_length - 1]
        for j, w in enumerate(words):
            ids[i, j] = 2 + int(hashlib.md5(w.encode()).hexdigest()[:8], 16) % (vocab_size - 2)
        ids[i, len(words)] = 1
    return ids


# ---------------------------------------------------------------- T5 encoder

def _t5_buckets(length: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    pos = torch.arange(length)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).long() * half
    rel = rel.abs()
    exact = half // 2
    large = exact + (torch.log(rel.float() / exact) / math.log(max_distance / exact)
                     * (half - exact)).long()
    large = torch.clamp_max(large, half - 1)
    return buckets + torch.where(rel < exact, rel, large)


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def t5_encode(W: Weights, cfg: dict, ids: torch.Tensor, P: Precision) -> torch.Tensor:
    """Last hidden state ``[B, L, d_model]`` of the encoder, no attention mask."""
    B, L = ids.shape
    H, dkv, eps = cfg["num_heads"], cfg["d_kv"], cfg["layer_norm_epsilon"]
    h = W["shared.weight"][ids]
    table = W["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    buckets = _t5_buckets(L, cfg["relative_attention_num_buckets"],
                          cfg["relative_attention_max_distance"]).to(table.device)
    bias = table[buckets].permute(2, 0, 1)[None]
    for i in range(cfg["num_layers"]):
        p = f"encoder.block.{i}.layer."
        x = _rms(h, W[p + "0.layer_norm.weight"], eps)

        def heads(name):
            return P.linear(x, W[p + f"0.SelfAttention.{name}.weight"]).view(
                B, L, H, dkv).transpose(1, 2)

        q, k, v = heads("q"), heads("k"), heads("v")
        scores = P.einsum("bhqd,bhkd->bhqk", q, k) + bias
        a = torch.softmax(scores, dim=-1)
        o = P.einsum("bhqk,bhkd->bhqd", a, v).transpose(1, 2).reshape(B, L, H * dkv)
        h = h + P.linear(o, W[p + "0.SelfAttention.o.weight"])
        x = _rms(h, W[p + "1.layer_norm.weight"], eps)
        ff = p + "1.DenseReluDense."
        if cfg["feed_forward_proj"] == "gated-gelu":
            inner = F.gelu(P.linear(x, W[ff + "wi_0.weight"]), approximate="tanh") \
                * P.linear(x, W[ff + "wi_1.weight"])
        else:
            inner = F.relu(P.linear(x, W[ff + "wi.weight"]))
        h = h + P.linear(inner, W[ff + "wo.weight"])
    return _rms(h, W["encoder.final_layer_norm.weight"], eps)


# ---------------------------------------------------------------- Band-MoE DiT

def _lin(W, P, x, name, bias=True):
    return P.linear(x, W[name + ".weight"], W.get(name + ".bias") if bias else None)


def _ln(x, W=None, name=None, eps=1e-6):
    w = None if W is None else W[name + ".weight"]
    b = None if W is None else W[name + ".bias"]
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def _attend(P, q, k, v):
    """``[B, T, H, D]`` attention, 1/sqrt(D) scaling, fp32 softmax."""
    logits = P.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    return P.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)


def _rope(head_dim: int, length: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    freqs = 1.0 / (10000.0 ** (np.arange(0, head_dim, 2)[: head_dim // 2].astype(np.float64)
                               / head_dim))
    ang = np.outer(np.arange(length, dtype=np.float64), freqs)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def _apply_rope(x, cos, sin):
    T = x.shape[1]
    a, b = x[..., 0::2], x[..., 1::2]
    c, s = cos[None, :T, None, :], sin[None, :T, None, :]
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(x.shape)


def _conv_stem(W, P, x, name):
    """conv k5 -> LeakyReLU(0.01) -> AvgPool(2) over ``[B, C, T]``."""
    h = P.conv(x, W[name + ".0.weight"], W[name + ".0.bias"], padding=2)
    return F.avg_pool1d(F.leaky_relu(h, 0.01), 2)


def dit_encode(W: Weights, cfg: dict, midi, beats, caption, P: Precision) -> dict:
    """The t-independent conditioning of the DiT: acoustic ``[B, T_mel/2, d]``,
    caption ``[B, Ty, d]`` and the pooled caption embedding ``[B, d]``."""
    midi_e = _conv_stem(W, P, W["midi_embedding.weight"][midi.long()].transpose(1, 2),
                        "midi_proj")
    beats_e = _conv_stem(W, P, W["beats_embedding.weight"][beats.long()].transpose(1, 2),
                         "beats_proj")
    acoustic = P.conv(midi_e + beats_e, W["final_proj.weight"], W["final_proj.bias"])
    cap = _lin(W, P, F.gelu(_lin(W, P, caption, "c_embedder.mlp.0")), "c_embedder.mlp.2")
    cap = _ln(cap, W, "c_embedder.norm")
    cap_emb = _lin(W, P, _ln(cap.mean(dim=1), W, "cap_embedder.0"), "cap_embedder.1")
    return {"acoustic": acoustic.transpose(1, 2), "caption": cap, "cap_emb": cap_emb}


def _swiglu(W, P, x, name, band=slice(None)):
    w1, w3 = W[name + ".w1.weight"][:, band], W[name + ".w3.weight"][:, band]
    w2 = W[name + ".w2.weight"][band]
    return P.linear(F.silu(P.linear(x, w1)) * P.linear(x, w3), w2)


def _routed_probs(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """Eval routing: the softmax's argmax as a straight-through one-hot."""
    soft = torch.softmax(logits / temperature, dim=-1)
    hard = F.one_hot(soft.argmax(dim=-1), logits.shape[-1]).to(soft.dtype)
    return hard - soft + soft


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in [0, 1)."""
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def anneal_temperature(step: int, init: float = 2.0) -> float:
    f32 = np.float32
    return float(max(f32(0.3), f32(init) * f32(0.9999) ** f32(step)))


def anneal_loss_weight(step: int) -> float:
    return float(max(np.float32(0.01), np.float32(0.9999) ** np.float32(step)))


def _band_moe(W, P, cfg, x, t_emb, caption, acoustic, name, train=None):
    """The Band-MoE FFN. ``train``: None for eval routing (argmax experts at
    the step-0 temperature), or ``(step, (hl, cap, ac))`` with the block's
    Gumbel noise for training routing (soft); then ``(out, load-balance)``."""
    B, T, d = x.shape
    E = cfg["num_experts"]
    ipw, ipb = W[name + ".cross_attention.in_proj_weight"], W[name + ".cross_attention.in_proj_bias"]
    (wq, wk, wv), (bq, bk, bv) = ipw.chunk(3), ipb.chunk(3)
    hd = d // 8
    q = P.linear(x, wq, bq).view(B, T, 8, hd)
    k = P.linear(caption, wk, bk).view(B, caption.shape[1], 8, hd)
    v = P.linear(caption, wv, bv).view(B, caption.shape[1], 8, hd)
    cap_feat = _lin(W, P, _attend(P, q, k, v).reshape(B, T, d), name + ".cross_attention.out_proj")
    hl_logits = _lin(W, P, t_emb, name + ".high_level_gating_network")
    cap_logits = _lin(W, P, cap_feat, name + ".caption_gating_network")
    ac_logits = _lin(W, P, acoustic, name + ".acoustic_gating_network")
    if train is None:
        temperature = anneal_temperature(0)  # the sampler calls the model at step 0
        hl = torch.softmax(hl_logits, dim=-1)
        cap_p = _routed_probs(cap_logits, temperature)
        ac_p = _routed_probs(ac_logits, temperature)
    else:
        step, (g_hl, g_cap, g_ac) = train
        temperature = anneal_temperature(step)
        hl = torch.softmax(hl_logits + g_hl, dim=-1)
        cap_p = torch.softmax((cap_logits + g_cap) / temperature, dim=-1)
        ac_p = torch.softmax((ac_logits + g_ac) / temperature, dim=-1)
    cap = torch.stack([_swiglu(W, P, x, f"{name}.caption_experts.{e}") for e in range(E)])
    ac = torch.stack([_swiglu(W, P, x, f"{name}.acoustic_experts.{e}") for e in range(E)])
    mixed = (torch.einsum("ebtd,bte->btd", cap, cap_p) * hl[:, 0, None, None]
             + torch.einsum("ebtd,bte->btd", ac, ac_p) * hl[:, 1, None, None])
    band = d // E
    out = torch.cat([_swiglu(W, P, mixed[..., e * band:(e + 1) * band],
                             f"{name}.freq_experts.{e}", slice(e * band, (e + 1) * band))
                     for e in range(E)], dim=-1)
    if train is None:
        return out
    # the load balance: each expert's gate mass over the tokens of its group
    mask = torch.cat([hl[:, 0, None].expand(B, T).reshape(-1, 1).expand(-1, E),
                      hl[:, 1, None].expand(B, T).reshape(-1, 1).expand(-1, E)], dim=1)
    probs = torch.cat([cap_p.reshape(-1, E), ac_p.reshape(-1, E)], dim=1)
    usage = (probs * mask).sum(0) / (mask.sum() + 1e-10)
    return out, torch.mean(usage * torch.log(usage + 1e-10))


def _timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def dit_velocity(W: Weights, cfg: dict, x: torch.Tensor, t: torch.Tensor, enc: dict,
                 rope, P: Precision, train=None):
    """The flow field ``[B, C, T]`` at latent ``x`` and timesteps ``t``.
    ``train``: ``(step, noise)`` with ``noise(shape)`` the next uniform draw,
    for training routing; then ``(v, load-balance loss)``."""
    d, H = cfg["hidden_size"], cfg["num_heads"]
    hd, eps = d // H, cfg.get("norm_eps", 1e-5)
    acoustic, caption, cap_emb = enc["acoustic"], enc["caption"], enc["cap_emb"]
    h = P.conv(x, W["proj_in.weight"], W["proj_in.bias"], padding=2).transpose(1, 2)
    B, T, _ = h.shape
    Ta = acoustic.shape[1]
    if T > Ta:
        acoustic = torch.cat([acoustic, acoustic[:, -1:].expand(-1, T - Ta, -1)], dim=1)
    elif Ta > T:
        acoustic = acoustic[:, :T]
    t_emb = _lin(W, P, F.silu(_lin(W, P, _timestep_embedding(t), "t_embedder.mlp.0")),
                 "t_embedder.mlp.2")
    h = acoustic + h
    c = t_emb + cap_emb
    cos, sin = rope
    lb_total = 0.0
    for i in range(cfg["depth"]):
        p = f"layers.{i}."
        mod = _lin(W, P, F.silu(c), p + "adaLN_modulation.1").chunk(6, dim=-1)
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = (m[:, None, :] for m in mod)
        a_in = _rms(h, W[p + "attention_norm.weight"], eps) * (1 + sc_a) + sh_a
        y = _rms(caption, W[p + "attention_y_norm.weight"], eps)
        at = p + "attention."
        q = _apply_rope(_lin(W, P, a_in, at + "wq", False).view(B, T, H, hd), cos, sin)
        k = _apply_rope(_lin(W, P, a_in, at + "wk", False).view(B, T, H, hd), cos, sin)
        v = _lin(W, P, a_in, at + "wv", False).view(B, T, H, hd)
        out = _attend(P, q, k, v)
        ky = _lin(W, P, y, at + "wk_y", False).view(B, y.shape[1], H, hd)
        vy = _lin(W, P, y, at + "wv_y", False).view(B, y.shape[1], H, hd)
        out = out + _attend(P, q, ky, vy) * torch.tanh(W[at + "gate"])[None, None, :, None]
        h = h + g_a * _lin(W, P, out.reshape(B, T, d), at + "wo", False)
        f_in = _rms(h, W[p + "ffn_norm.weight"], eps) * (1 + sc_f) + sh_f
        if train is None:
            h = h + g_f * _band_moe(W, P, cfg, f_in, t_emb, caption, acoustic, p + "feed_forward")
        else:
            step, draw = train
            E = cfg["num_experts"]
            noise = [gumbel(draw(shape)) for shape in ((B, 2), (B, T, E), (B, T, E))]
            out, lb = _band_moe(W, P, cfg, f_in, t_emb, caption, acoustic, p + "feed_forward",
                                (step, noise))
            h = h + g_f * out
            lb_total = lb_total + lb
    shift, scale = _lin(W, P, F.silu(c), "final_layer.adaLN_modulation.1").chunk(2, dim=-1)
    h = _ln(h) * (1 + scale[:, None]) + shift[:, None]
    v = _lin(W, P, h, "final_layer.linear").transpose(1, 2)
    if train is None:
        return v
    return v, lb_total / cfg["depth"] * anneal_loss_weight(train[0])


def euler_schedule(num_steps: int = 25, num_timesteps: int = 1000):
    """Floored model timesteps and step sizes over ``linspace(0, 1, n)`` in
    float32, the division by a constant taken as a multiply by its reciprocal."""
    f32 = np.float32
    div = num_steps - 1
    ts = np.concatenate([np.arange(div, dtype=f32) * (f32(1.0) / f32(div)), [f32(1.0)]])
    ts = ts.astype(f32)
    return np.floor(ts[:-1] * f32(num_timesteps)).astype(f32), (ts[1:] - ts[:-1]).astype(f32)


def sample_cfg(W: Weights, cfg: dict, x0, cond: dict, uncond: dict, scale: float,
               steps: int, P: Precision) -> torch.Tensor:
    """CFG Euler integration from ``x0`` ``[B, C, T]``; ``cond``/``uncond``
    hold ``caption`` (tower states) and ``midi``/``beats`` ``[B, 1, T_mel]``."""
    n = 2 * x0.shape[0]
    cat = {k: torch.cat([cond[k], uncond[k]]) for k in ("caption", "midi", "beats")}
    enc = dit_encode(W, cfg, cat["midi"][:, 0], cat["beats"][:, 0], cat["caption"], P)
    rope = _rope(cfg["hidden_size"] // cfg["num_heads"], cfg["max_len"], x0.device)
    t_int, dt = euler_schedule(steps)
    x = x0
    for i in range(len(dt)):
        t = torch.full((n,), float(t_int[i]), device=x0.device)
        v_c, v_u = dit_velocity(W, cfg, torch.cat([x, x]), t, enc, rope, P).chunk(2)
        x = x + float(dt[i]) * (v_u + scale * (v_c - v_u))
    return x


# ---------------------------------------------------------------- VAE decoder

def _gn(W, x, name):
    c = x.shape[1]
    return F.group_norm(x, 32 if c >= 32 else c, W[name + ".weight"], W[name + ".bias"], 1e-6)


def _conv_named(W, P, x, name, k):
    return P.conv(x, W[name + ".weight"], W[name + ".bias"], padding=k // 2)


def _resnet(W, P, x, name, k):
    h = _conv_named(W, P, F.silu(_gn(W, x, name + ".norm1")), name + ".conv1", k)
    h = _conv_named(W, P, F.silu(_gn(W, h, name + ".norm2")), name + ".conv2", k)
    if name + ".nin_shortcut.weight" in W:
        x = _conv_named(W, P, x, name + ".nin_shortcut", 1)
    return x + h


def _attn_1d(W, P, x, name):
    h = _gn(W, x, name + ".norm")
    q, k, v = (_conv_named(W, P, h, f"{name}.{n}", 1) for n in "qkv")
    w = torch.softmax(P.einsum("bcq,bck->bqk", q, k) * q.shape[1] ** -0.5, dim=-1)
    return x + _conv_named(W, P, P.einsum("bqk,bck->bcq", w, v), name + ".proj_out", 1)


def vae_decode(W: Weights, dd: dict, z: torch.Tensor, P: Precision) -> torch.Tensor:
    """Latent ``[B, embed_dim, T']`` -> mel ``[B, out_ch, T]``."""
    k, n_levels = dd.get("kernel_size", 3), len(dd["ch_mult"])
    up_layers = [i + 1 for i in dd.get("down_layers", ())]
    h = _conv_named(W, P, z, "post_quant_conv", 1)
    h = _conv_named(W, P, h, "decoder.conv_in", k)
    h = _resnet(W, P, h, "decoder.mid.block_1", 3)
    h = _attn_1d(W, P, h, "decoder.mid.attn_1")
    h = _resnet(W, P, h, "decoder.mid.block_2", 3)
    for i in reversed(range(n_levels)):
        for j in range(dd["num_res_blocks"] + 1):
            h = _resnet(W, P, h, f"decoder.up.{i}.block.{j}", 3)
            if f"decoder.up.{i}.attn.{j}.q.weight" in W:
                h = _attn_1d(W, P, h, f"decoder.up.{i}.attn.{j}")
        if i in up_layers:
            h = _conv_named(W, P, torch.repeat_interleave(h, 2, dim=2),
                            f"decoder.up.{i}.upsample.conv", 3)
    return _conv_named(W, P, F.silu(_gn(W, h, "decoder.norm_out")), "decoder.conv_out", k)


# ---------------------------------------------------------------- HiFi-GAN

def hifigan(W: Weights, cfg: dict, mel: torch.Tensor, P: Precision) -> torch.Tensor:
    """mel ``[B, 80, T]`` -> waveform ``[B, T * prod(upsample_rates)]``."""
    slope = 0.1
    x = P.conv(mel, W["conv_pre.weight"], W["conv_pre.bias"], padding=3)
    K = len(cfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        x = P.conv_t(F.leaky_relu(x, slope), W[f"ups.{i}.weight"], W[f"ups.{i}.bias"],
                     stride=u, padding=(k - u) // 2)
        acc = 0
        for j, (rk, rd) in enumerate(zip(cfg["resblock_kernel_sizes"],
                                         cfg["resblock_dilation_sizes"])):
            y, p = x, f"resblocks.{i * K + j}."
            for n, d in enumerate(rd):
                h = P.conv(F.leaky_relu(y, slope), W[p + f"convs1.{n}.weight"],
                           W[p + f"convs1.{n}.bias"], dilation=d, padding=(rk * d - d) // 2)
                h = P.conv(F.leaky_relu(h, slope), W[p + f"convs2.{n}.weight"],
                           W[p + f"convs2.{n}.bias"], padding=(rk - 1) // 2)
                y = y + h
            acc = acc + y
        x = acc / K
    x = P.conv(F.leaky_relu(x, 0.01), W["conv_post.weight"], W["conv_post.bias"], padding=3)
    return torch.tanh(x)[:, 0]
