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
                                        *_weights(blk), dilation, fw.PackCache())
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
                                        *_weights(blk), 3, fw.PackCache())
    assert xo.dtype == torch.bfloat16 and so.dtype == torch.float32
    # bf16 inputs (2^-9 relative) through a 3R + A = 29-term sum, and x' rounded
    assert np.abs(xo.float().numpy() - xo32).max() <= 2e-2 * np.abs(xo32).max()
    assert np.abs(so.numpy() - so32).max() <= 2e-2 * np.abs(so32).max()


def test_rejects_bad_inputs():
    blk = _layer(50, 1)
    x, c, skip = (torch.from_numpy(a) for a in _data(50, 1, 16))
    with pytest.raises(TypeError, match="fp32 accumulator"):
        fw.fused_wavenet_layer(x, c, skip.double(), *_weights(blk), 1, fw.PackCache())
    with pytest.raises(ValueError, match="dilation"):
        fw.fused_wavenet_layer(x, c, skip, *_weights(blk), 0, fw.PackCache())
    with pytest.raises(ValueError, match="mismatch"):
        fw.fused_wavenet_layer(x, c[..., :8], skip, *_weights(blk), 1, fw.PackCache())
    meta = [t.to("meta") for t in (x, c, skip)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fw.fused_wavenet_layer(*meta, *_weights(blk), 1, fw.PackCache())


def test_pack_weights_layout():
    """K5's operands: the gate matrix ``[128, K8]`` with m-tile m's rows r < 8
    the tanh rows of units 8m + r and rows r + 8 their sigmoid rows, columns
    tap-major gate taps then aux, zero-padded to a multiple of 8; the
    skip/out matrix ``[128, 64]`` with skip in rows [0, S), out in [64, 64 +
    R), the unit as column; both in mma fragment order (lane 4g + t: rows g,
    g + 8 at column t, then at t + 4)."""
    blk = _layer(60, 1)
    wg, bg, wso, bso = fw.pack_matrices(*_weights(blk))
    G = G2 // 2  # 8: units 0..7 fill m-tile 0; m-tiles 1..7 are zero
    K = 3 * R + A
    assert wg.shape == (128, 32) and wso.shape == (128, 64)
    w = blk.conv.weight.detach()
    assert torch.equal(wg[3, 2 * R + 1], w[3, 1, 2])        # tanh row of unit 3, tap t+d
    assert torch.equal(wg[8 + 3, R + 5], w[G + 3, 5, 1])    # its sigmoid row, tap t
    assert torch.equal(wg[8 + 2, 3 * R + 2], blk.conv1x1_aux.weight.detach()[G + 2, 2, 0])
    assert wg[16:].abs().sum() == 0 and wg[:, K:].abs().sum() == 0
    assert torch.equal(bg[8:16], blk.conv.bias.detach()[G:]) and bg[16:].abs().sum() == 0
    assert torch.equal(wso[64 + 5, 3], blk.conv1x1_out.weight.detach()[5, 3, 0])
    assert wso[:, G:].abs().sum() == 0 and wso[S:64].abs().sum() == 0
    assert torch.equal(bso[:S], blk.conv1x1_skip.bias.detach()) and bso[S:64].abs().sum() == 0
    assert math.isclose(bso[64].item(), blk.conv1x1_out.bias[0].item())
    fwg, fbg, fwso, fbso = fw.pack_weights(*_weights(blk))
    assert fwg.shape == (8, 4, 32, 4) and fwso.shape == (8, 8, 32, 4)
    assert torch.equal(fbg, bg) and torch.equal(fbso, bso)
    for frag, mat in ((fwg, wg), (fwso, wso)):
        for lane in (0, 5, 31):
            g, t = lane >> 2, lane & 3
            assert frag[0, 1, lane].tolist() == [mat[g, 8 + t], mat[g + 8, 8 + t],
                                                 mat[g, 12 + t], mat[g + 8, 12 + t]]


def test_pack_cache_repacks_only_when_a_weight_changes():
    blk = _layer(61, 1)
    cache = fw.PackCache()
    first = cache.get(*_weights(blk))
    assert cache.get(*_weights(blk)) is first  # nothing changed: no repack
    with torch.no_grad():
        blk.conv1x1_out.weight.mul_(3.0)  # in place: a new version
    second = cache.get(*_weights(blk))
    assert second is not first and not torch.equal(second[2], first[2])
    assert torch.equal(second[2], fw.pack_weights(*_weights(blk))[2])
    other = _layer(62, 1)
    blk.load_state_dict(other.state_dict())
    assert torch.equal(cache.get(*_weights(blk))[0], fw.pack_weights(*_weights(other))[0])
    blk.conv.weight = torch.nn.Parameter(blk.conv.weight.detach() * 2)  # new storage
    assert torch.equal(cache.get(*_weights(blk))[0], fw.pack_weights(*_weights(blk))[0])


def test_pack_cache_takes_weights_made_in_inference_mode():
    """Inference tensors have no version counter: a layer built under
    ``torch.inference_mode`` is keyed on its weights' storage alone, and a
    weight given new storage is packed again."""
    with torch.inference_mode():
        blk = _layer(63, 1)
        assert blk.conv.weight.is_inference()
        cache = fw.PackCache()
        first = cache.get(*_weights(blk))
        assert cache.get(*_weights(blk)) is first
        blk.conv.weight = torch.nn.Parameter(blk.conv.weight * -2.0, requires_grad=False)
        second = cache.get(*_weights(blk))
        assert torch.equal(second[0], fw.pack_weights(*_weights(blk))[0])
        assert not torch.equal(second[0], first[0])
    assert cache.get(*_weights(blk)) is second  # and outside inference mode
