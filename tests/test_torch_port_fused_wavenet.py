"""K5's plain version (the CPU path of ``fused_wavenet_layer``) and the
port's PWG ``ResidualBlock`` against ``versband_tpu`` (fp32, CPU).

The port takes ``[B, C, T]`` and ``nn.Conv1d`` weights where the JAX side
takes ``[B, T, C]`` and flax kernels: inputs, weights and outputs are
transposed here. Against the JAX ``ResidualBlock``'s dense path at any T,
and against the JAX Pallas kernel itself (``fused_wavenet_layer``, interpret
mode) at T = 1024 with 512-sample blocks, the size its block grid takes.
Tiny channels, dilations 1, 4 and 512. Tolerance 1e-5 of the output's
largest value (JAX's bar for K5; fp32 sums in another order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.ops.fused_wavenet import fused_wavenet_layer as jax_fused
from versband_tpu.utils.torch_convert import convert_state_dict
from versband_tpu.vocoder.pwg import ResidualBlock as JBlock
from versband_tpu_torch.ops import fused_wavenet as fw
from versband_tpu_torch.vocoder.pwg import ResidualBlock

TOL = 1e-5
R, G2, S, A = 8, 16, 6, 5  # residual, gate (2G), skip, aux


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())


def _layer(seed, dilation):
    torch.manual_seed(seed)
    blk = ResidualBlock(3, R, G2, S, A, dilation).eval()
    with torch.no_grad():  # biases away from their init scale
        for p in blk.parameters():
            p.mul_(2.0)
    return blk


def _data(seed, B, T):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in ((B, R, T), (B, A, T), (B, S, T))]


def _weights(blk):
    return (blk.conv.weight, blk.conv.bias, blk.conv1x1_aux.weight, blk.conv1x1_skip.weight,
            blk.conv1x1_skip.bias, blk.conv1x1_out.weight, blk.conv1x1_out.bias)


def _port(blk, x, c, skip, dilation):
    n = fw.LAUNCHES
    with torch.no_grad():
        sk = torch.from_numpy(skip)
        xo, so = fw.fused_wavenet_layer(torch.from_numpy(x), torch.from_numpy(c), sk,
                                        *_weights(blk), dilation)
    assert fw.LAUNCHES == n and torch.equal(sk, torch.from_numpy(skip))  # skip not updated
    assert so.dtype == torch.float32
    return xo.numpy(), so.numpy()


def _jax_block_params(blk):
    sd = {"conv_layers.0." + k: v.detach().numpy() for k, v in blk.state_dict().items()}
    return {"params": convert_state_dict(sd, "pwg")["params"]["conv_layers_0"]}


def _t(a):
    return jnp.asarray(a.transpose(0, 2, 1))


@pytest.mark.parametrize("dilation", [1, 4, 512])
def test_plain_matches_the_jax_dense_layer(dilation):
    blk = _layer(dilation, dilation)
    x, c, skip = _data(dilation, 2, 601)
    xo, so = _port(blk, x, c, skip, dilation)
    jout, js = JBlock(3, R, G2, S, A, dilation, use_weight_norm=False).apply(
        _jax_block_params(blk), _t(x), _t(c))
    _close(xo, np.asarray(jout).transpose(0, 2, 1))
    _close(so, skip + np.asarray(js).transpose(0, 2, 1))


@pytest.mark.parametrize("dilation", [1, 4, 512])
def test_plain_matches_the_jax_kernel(dilation):
    blk = _layer(10 + dilation, dilation)
    x, c, skip = _data(10 + dilation, 1, 1024)
    xo, so = _port(blk, x, c, skip, dilation)
    w = {k: v.detach().numpy() for k, v in zip(("wg", "bg", "wa", "ws", "bs", "wo", "bo"),
                                                _weights(blk))}
    jx, js = jax_fused(
        _t(x), _t(c), _t(skip), jnp.asarray(w["wg"].transpose(2, 1, 0)), jnp.asarray(w["bg"]),
        jnp.asarray(w["wa"][:, :, 0].T), jnp.asarray(w["ws"][:, :, 0].T), jnp.asarray(w["bs"]),
        jnp.asarray(w["wo"][:, :, 0].T), jnp.asarray(w["bo"]), dilation, 1024, block_t=512,
        interpret=True)
    _close(xo, np.asarray(jx).transpose(0, 2, 1))
    _close(so, np.asarray(js).transpose(0, 2, 1))


@pytest.mark.parametrize("with_skip", [True, False])
def test_residual_block_module_matches_jax(with_skip):
    """The port's module on both its paths (with ``skip``: the fused call,
    here its plain version) against the JAX module's dense path."""
    blk = _layer(20, 2)
    x, c, skip = _data(20, 2, 50)
    with torch.no_grad():
        out, s = blk(torch.from_numpy(x), torch.from_numpy(c),
                     torch.from_numpy(skip) if with_skip else None)
    jout, js = JBlock(3, R, G2, S, A, 2, use_weight_norm=False).apply(
        _jax_block_params(blk), _t(x), _t(c))
    _close(out.numpy(), np.asarray(jout).transpose(0, 2, 1))
    _close(s.numpy(), (skip if with_skip else 0) + np.asarray(js).transpose(0, 2, 1))


def test_no_aux_runs_the_dense_path():
    blk = _layer(30, 1)
    x, _, skip = _data(30, 1, 40)
    with torch.no_grad():
        out, s = blk(torch.from_numpy(x), None, torch.from_numpy(skip))
    jp = _jax_block_params(blk)
    jout, js = JBlock(3, R, G2, S, A, 1, use_weight_norm=False).apply(jp, _t(x), None)
    _close(out.numpy(), np.asarray(jout).transpose(0, 2, 1))
    _close(s.numpy(), skip + np.asarray(js).transpose(0, 2, 1))


def test_plain_keeps_bf16_and_fp32_skip():
    blk = _layer(40, 3)
    x, c, skip = _data(40, 1, 33)
    xo32, so32 = _port(blk, x, c, skip, 3)
    with torch.no_grad():
        xo, so = fw.fused_wavenet_layer(torch.from_numpy(x).bfloat16(),
                                        torch.from_numpy(c).bfloat16(), torch.from_numpy(skip),
                                        *_weights(blk), 3)
    assert xo.dtype == torch.bfloat16 and so.dtype == torch.float32
    # bf16 inputs (2^-9 relative) through a 3R + A = 29-term sum, and x' rounded
    assert np.abs(xo.float().numpy() - xo32).max() <= 2e-2 * np.abs(xo32).max()
    assert np.abs(so.numpy() - so32).max() <= 2e-2 * np.abs(so32).max()


def test_rejects_bad_inputs():
    blk = _layer(50, 1)
    x, c, skip = (torch.from_numpy(a) for a in _data(50, 1, 16))
    with pytest.raises(TypeError, match="fp32 accumulator"):
        fw.fused_wavenet_layer(x, c, skip.double(), *_weights(blk), 1)
    with pytest.raises(ValueError, match="dilation"):
        fw.fused_wavenet_layer(x, c, skip, *_weights(blk), 0)
    with pytest.raises(ValueError, match="mismatch"):
        fw.fused_wavenet_layer(x, c[..., :8], skip, *_weights(blk), 1)
    meta = [t.to("meta") for t in (x, c, skip)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fw.fused_wavenet_layer(*meta, *_weights(blk), 1)


def test_pack_weights_layout():
    """K5's operand rows: tap-major gate taps then aux; tanh half in columns
    [0, G), sigmoid half in [64, 64 + G); skip in [0, S), out in [64, 64 + R)."""
    blk = _layer(60, 1)
    wk, bg, wso, bso = fw.pack_weights(*_weights(blk))
    G = G2 // 2
    assert wk.shape == (3 * R + A, 128) and wso.shape == (64, 128)
    w = blk.conv.weight.detach()
    assert torch.equal(wk[2 * R + 1, :G], w[:G, 1, 2])
    assert torch.equal(wk[R, 64:64 + G], w[G:, 0, 1])
    assert torch.equal(wk[3 * R + 2, 64 + 3], blk.conv1x1_aux.weight.detach()[G + 3, 2, 0])
    assert wk[:, G:64].abs().sum() == 0 and wk[:, 64 + G:].abs().sum() == 0
    assert torch.equal(bg[64:64 + G], blk.conv.bias.detach()[G:])
    assert torch.equal(wso[3, 64 + 5], blk.conv1x1_out.weight.detach()[5, 3, 0])
    assert torch.equal(bso[:S], blk.conv1x1_skip.bias.detach()) and bso[S:64].abs().sum() == 0
    assert math.isclose(bso[64].item(), blk.conv1x1_out.bias[0].item())
