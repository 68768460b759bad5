"""Shared pieces of the port's parity tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both packages; weights
go from the port to JAX through the JAX package's own converter
(``versband_tpu.utils.torch_convert.convert_state_dict``) or from JAX to the
port through ``versband_tpu_torch.utils.convert.state_dict_from_jax``.
"""

import numpy as np
import torch

from versband_tpu.utils.torch_convert import convert_state_dict
from versband_tpu_torch.utils.convert import state_dict_from_jax

MIDI_V, BEATS_V = 130, 3

# tiny geometries (the JAX suite's own tiny cases)
DIT_TINY = dict(in_channels=4, context_dim=16, hidden_size=16, depth=2, num_heads=2,
                max_len=64, num_experts=2, ori_dim=12, multiple_of=8)
VAE_TINY = dict(embed_dim=4, ddconfig=dict(
    double_z=True, in_channels=80, out_ch=80, z_channels=4, kernel_size=5, ch=32,
    ch_mult=[1, 2], num_res_blocks=2, attn_layers=[0, 1], down_layers=[0], dropout=0.0))
VOC_TINY = dict(upsample_initial_channel=32, upsample_rates=(4, 4),
                upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 7),
                resblock_dilation_sizes=((1, 3, 5),) * 2)


def to_jax(module: torch.nn.Module, family: str, **kw):
    """The port module's weights as a JAX param tree, via the JAX converter."""
    sd = {k: v.detach().float().numpy() for k, v in module.state_dict().items()}
    return convert_state_dict(sd, family, **kw)


def load_from_jax(module: torch.nn.Module, params, wrap: str = "m",
                  prefix: str = "m.") -> torch.nn.Module:
    """Load a JAX sub-module's params into a port module of the same layout.

    The tree is nested under ``wrap`` and converted with the 'dit' family, so
    reference names (``t_embedder`` -> ``t_embedder.mlp.0``) apply; ``prefix``
    is then stripped from the keys.
    """
    sd = state_dict_from_jax({wrap: params["params"]}, "dit")
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return module


def perturb_zero_init(module: torch.nn.Module, seed: int, std: float = 0.2) -> None:
    """adaLN-zero layers and attention gates start at 0, which makes a DiT's
    output identically 0; give them random values."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "adaLN" in name or "final_layer" in name or name.endswith("gate"):
                p.copy_(torch.randn(p.shape, generator=g) * std)


def dit_inputs(rng: np.random.RandomState, B: int, t_mel: int, ori: int, in_ch: int,
               n_cap: int = 5):
    """(x, t, midi, beats, caption) numpy inputs of a DiT forward."""
    x = rng.randn(B, in_ch, t_mel // 2).astype(np.float32)
    t = rng.uniform(0, 999, (B,)).astype(np.float32)
    midi = rng.randint(0, MIDI_V, (B, 1, t_mel)).astype(np.int64)
    beats = rng.randint(0, BEATS_V, (B, 1, t_mel)).astype(np.int64)
    caption = rng.randn(B, n_cap, ori).astype(np.float32)
    return x, t, midi, beats, caption


def torch_context(midi, beats, caption):
    return {"c_concat": {"midi": torch.from_numpy(midi), "beats": torch.from_numpy(beats)},
            "c_crossattn": torch.from_numpy(caption)}


def jax_context(midi, beats, caption):
    import jax.numpy as jnp

    return {"c_concat": {"midi": jnp.asarray(midi), "beats": jnp.asarray(beats)},
            "c_crossattn": jnp.asarray(caption)}


class Draws:
    """Stands in for a ``jax.random`` sampler: returns the given arrays (in
    their own dtypes) in call order."""

    def __init__(self, arrays):
        self.queue = [np.asarray(a) for a in arrays]

    def __call__(self, key, shape=(), *args, **kwargs):
        import jax.numpy as jnp

        a = self.queue.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a)


def assert_grads_match(model, jax_grads, tol=1e-4, floor=1e-3):
    """The module's ``.grad`` against a JAX gradient tree (mapped with
    ``state_dict_from_jax``), leaf by leaf: within ``tol`` of the leaf's own
    largest JAX gradient, or of ``floor`` x the largest over all leaves where
    the leaf's own is smaller (a leaf near 0 has no scale of its own). The
    self-attention projections, which the flash kernels' backward feeds, must
    get a nonzero gradient."""
    ref = state_dict_from_jax(jax_grads, "dit")
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(ref) == set(got)
    scale = max(v.abs().max().item() for v in ref.values())
    assert scale > 0
    for k, g in got.items():
        g = torch.zeros_like(ref[k]) if g is None else g
        err = (g - ref[k]).abs().max().item()
        own = ref[k].abs().max().item()
        assert err <= tol * max(own, floor * scale), (k, err, own, scale)
        if k.endswith(("attention.wq.weight", "attention.wk.weight", "attention.wv.weight")):
            assert g.abs().max().item() > 0, k
