"""Model FLOPs from the configurations' shapes: 2 per multiply-add of every
matrix product and convolution (attention's two products included),
elementwise work left out, as model FLOP utilisation counts them.

The Band-MoE DiT is counted with the experts a token uses at eval: its
argmax caption expert and its argmax acoustic expert, and the frequency
experts, which together are one expert's work (each expert on its quarter
of the channels). The port computes every expert densely; a routed path
would do less work for the same model FLOPs.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence


def linear(rows: int, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def conv1d(batch: int, t_out: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * batch * t_out * c_in * c_out * k


def attention(batch: int, heads: int, tq: int, tk: int, d: int) -> float:
    """q k^T and p v."""
    return 4.0 * batch * heads * tq * tk * d


def swiglu_hidden(dim: int, multiple_of: int = 256) -> int:
    h = int(2 * dim / 3)
    return multiple_of * ((h + multiple_of - 1) // multiple_of)


def t5_encoder(cfg: Dict[str, Any], batch: int, length: int) -> float:
    d, dkv, h, dff = cfg["d_model"], cfg["d_kv"], cfg["num_heads"], cfg["d_ff"]
    rows = batch * length
    per_block = 4 * linear(rows, d, h * dkv) + attention(batch, h, length, length, dkv)
    n_wi = 2 if cfg.get("feed_forward_proj") == "gated-gelu" else 1
    per_block += n_wi * linear(rows, d, dff) + linear(rows, dff, d)
    return cfg["num_layers"] * per_block


def dit_encode(cfg: Dict[str, Any], batch: int, t_mel: int, t_caption: int) -> float:
    """The t-independent conditioning: the midi and beats stems, the caption
    projection and the pooled caption embedding."""
    d, ori = cfg["hidden_size"], cfg["ori_dim"]
    stems = 2 * conv1d(batch, t_mel, d, d, 5) + conv1d(batch, t_mel // 2, d, d, 1)
    caption = linear(batch * t_caption, ori, d) + linear(batch * t_caption, d, d)
    return stems + caption + linear(batch, d, d)


def dit_forward(cfg: Dict[str, Any], batch: int, t: int, t_caption: int,
                dense: bool = False) -> float:
    """One forward of the backbone on encoded conditioning; ``dense``: every
    expert, as training's soft routing uses them all."""
    d, c, heads = cfg["hidden_size"], cfg["in_channels"], cfg["num_heads"]
    hd = d // heads
    hidden = swiglu_hidden(d, cfg.get("multiple_of", 256))
    rows, cap_rows = batch * t, batch * t_caption
    block = linear(batch, d, 6 * d)
    # joint attention: q k v o, self attention, the caption's k v, cross attention
    block += 4 * linear(rows, d, d) + attention(batch, heads, t, t, hd)
    block += 2 * linear(cap_rows, d, d) + attention(batch, heads, t, t_caption, hd)
    # Band-MoE: caption cross-attention, gates, two routed experts, frequency experts
    block += 2 * linear(rows, d, d) + 2 * linear(cap_rows, d, d)
    block += attention(batch, 8, t, t_caption, d // 8)
    block += linear(batch, d, 2) + 2 * linear(rows, d, cfg["num_experts"])
    experts = 2 * cfg["num_experts"] + 1 if dense else 3
    block += experts * 3 * linear(rows, d, hidden)
    if dense:  # the gates' mixture of the stacked experts
        block += 2 * 2.0 * cfg["num_experts"] * rows * d
    out = conv1d(batch, t, c, d, 5) + linear(batch, 256, d) + linear(batch, d, d)
    out += linear(batch, d, 2 * d) + linear(rows, d, c)
    return cfg["depth"] * block + out


def _resnet(batch, t, cin, cout, k):
    f = conv1d(batch, t, cin, cout, k) + conv1d(batch, t, cout, cout, k)
    return f + (conv1d(batch, t, cin, cout, 1) if cin != cout else 0.0)


def _attn(batch, t, c):
    return 4 * conv1d(batch, t, c, c, 1) + attention(batch, 1, t, t, c)


def vae_encode(dd: Dict[str, Any], embed_dim: int, batch: int, t_mel: int) -> float:
    """``Encoder1D`` (res blocks at the configured kernel) and the quant conv."""
    ch, mult, k = dd["ch"], list(dd["ch_mult"]), dd.get("kernel_size", 3)
    t, block_in = t_mel, ch
    f = conv1d(batch, t, dd["in_channels"], ch, k)
    for i, m in enumerate(mult):
        for j in range(dd["num_res_blocks"]):
            f += _resnet(batch, t, block_in, ch * m, k)
            block_in = ch * m
            if i in dd.get("attn_layers", ()):
                f += _attn(batch, t, block_in)
        if i in dd.get("down_layers", ()):
            t //= 2
            f += conv1d(batch, t, block_in, block_in, 3)
    f += 2 * _resnet(batch, t, block_in, block_in, k) + _attn(batch, t, block_in)
    z2 = 2 * dd["z_channels"]
    return f + conv1d(batch, t, block_in, z2, k) + conv1d(batch, t, z2, 2 * embed_dim, 1)


def vae_decode(dd: Dict[str, Any], embed_dim: int, batch: int, t_latent: int) -> float:
    """``AutoencoderKL.decode``: post-quant conv, then ``Decoder1D`` (res
    blocks at kernel 3, one upsample per encoder downsample)."""
    ch, mult, k = dd["ch"], list(dd["ch_mult"]), dd.get("kernel_size", 3)
    n_res, z = dd["num_res_blocks"], dd["z_channels"]
    up_layers = [i + 1 for i in dd.get("down_layers", ())]
    attn_layers = list(dd.get("attn_layers", ()))

    t = t_latent
    block_in = ch * mult[-1]
    f = conv1d(batch, t, embed_dim, z, 1) + conv1d(batch, t, z, block_in, k)
    f += 2 * _resnet(batch, t, block_in, block_in, 3) + _attn(batch, t, block_in)
    for i in reversed(range(len(mult))):
        block_out = ch * mult[i]
        for j in range(n_res + 1):
            f += _resnet(batch, t, block_in if j == 0 else block_out, block_out, 3)
            if i in attn_layers:
                f += _attn(batch, t, block_out)
        block_in = block_out
        if i in up_layers:
            t *= 2
            f += conv1d(batch, t, block_in, block_in, 3)
    return f + conv1d(batch, t, block_in, dd["out_ch"], k)


def patchgan(batch: int, height: int, width: int, ndf: int = 64, n_layers: int = 3) -> float:
    """``NLayerDiscriminator`` on ``[B, 1, height, width]``: 4x4 convs, padding 1."""
    f, c, h, w = 0.0, 1, height, width
    for n in range(n_layers + 2):
        out = 1 if n == n_layers + 1 else ndf * min(2 ** n, 8)
        stride = 2 if n < n_layers else 1
        h, w = (h + 2 - 4) // stride + 1, (w + 2 - 4) // stride + 1
        f += 2.0 * batch * h * w * c * out * 16
        c = out
    return f


def hifigan(cfg: Dict[str, Any], batch: int, t_mel: int) -> float:
    """``HifiGanGenerator``: conv_pre, per stage a transposed conv and the
    mean of its residual blocks, conv_post."""
    ch0 = cfg["upsample_initial_channel"]
    rates: Sequence[int] = cfg["upsample_rates"]
    kernels: Sequence[int] = cfg["upsample_kernel_sizes"]
    res_k: Sequence[int] = cfg["resblock_kernel_sizes"]
    res_d: Sequence[Sequence[int]] = cfg["resblock_dilation_sizes"]
    t = t_mel
    f = conv1d(batch, t, cfg["in_channels"], ch0, 7)
    ch = ch0
    for i, (u, k) in enumerate(zip(rates, kernels)):
        c_in, ch = ch, ch0 // (2 ** (i + 1))
        f += conv1d(batch, t, c_in, ch, k)  # each input frame meets k taps per output channel
        t *= u
        for rk, rd in zip(res_k, res_d):
            f += 2 * len(rd) * conv1d(batch, t, ch, ch, rk)
    return f + conv1d(batch, t, ch, 1, 7)
