"""The port's SpatialTransformer (``versband_tpu_torch/nn/spatial_transformer.py``)
against the JAX package's building blocks (fp32, CPU).

JAX ``nn/spatial_transformer.py`` calls ``CrossAttention(self.dim, None,
self.n_heads, self.d_head)`` against the fields ``(query_dim, heads,
dim_head)`` and cannot run (pinned below). The reference here is a flax
module written in the test with the JAX package's own ``CrossAttention``
(``models/concat_dit.py``) and ``GEGLU``, its call corrected to
``CrossAttention(dim, n_heads, d_head)``; nothing else differs from the JAX
module. Bar: 2e-4 max|d|; ``remat`` on and off equal to 1e-6, gradients too.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models.concat_dit import CrossAttention as JCrossAttention
from versband_tpu.nn import spatial_transformer as jst
from versband_tpu_torch.nn.spatial_transformer import SpatialTransformer

TOL = 2e-4
C, HEADS, DH, CTX = 16, 2, 8, 12


class JBlock(fnn.Module):
    dim: int
    n_heads: int
    d_head: int

    @fnn.compact
    def __call__(self, x, context=None):
        x = x + JCrossAttention(self.dim, self.n_heads, self.d_head, name="attn1")(
            fnn.LayerNorm(name="norm1")(x))
        x = x + JCrossAttention(self.dim, self.n_heads, self.d_head, name="attn2")(
            fnn.LayerNorm(name="norm2")(x), context)
        h = jst.GEGLU(self.dim * 4, name="ff_in")(fnn.LayerNorm(name="norm3")(x))
        return x + fnn.Dense(self.dim, name="ff_out")(h)


class JSpatial(fnn.Module):
    """JAX's SpatialTransformer with the attention call corrected."""

    depth: int = 2

    @fnn.compact
    def __call__(self, x, context=None):
        B, Cx, H, W = x.shape
        inner = HEADS * DH
        h = fnn.GroupNorm(num_groups=min(32, Cx), epsilon=1e-6, name="norm")(
            x.transpose(0, 2, 3, 1))
        h = fnn.Conv(inner, (1, 1), name="proj_in")(h).reshape(B, H * W, inner)
        for i in range(self.depth):
            h = JBlock(inner, HEADS, DH, name=f"blocks_{i}")(h, context)
        h = fnn.Conv(Cx, (1, 1), name="proj_out")(h.reshape(B, H, W, inner))
        return x + h.transpose(0, 3, 1, 2)


def _state(params) -> dict:
    """The flax tree under the reference's state_dict names."""
    p = params["params"]
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    sd = {"norm.weight": t(p["norm"]["scale"]), "norm.bias": t(p["norm"]["bias"])}
    for conv in ("proj_in", "proj_out"):
        sd[f"{conv}.weight"] = t(np.asarray(p[conv]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{conv}.bias"] = t(p[conv]["bias"])
    for i in range(2):
        b, pre = p[f"blocks_{i}"], f"transformer_blocks.{i}."
        for a in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                sd[f"{pre}{a}.{n}.weight"] = t(np.asarray(b[a][n]["kernel"]).T)
            sd[f"{pre}{a}.to_out.0.weight"] = t(np.asarray(b[a]["to_out"]["kernel"]).T)
            sd[f"{pre}{a}.to_out.0.bias"] = t(b[a]["to_out"]["bias"])
        for n in ("norm1", "norm2", "norm3"):
            sd[f"{pre}{n}.weight"], sd[f"{pre}{n}.bias"] = t(b[n]["scale"]), t(b[n]["bias"])
        sd[f"{pre}ff.net.0.proj.weight"] = t(np.asarray(b["ff_in"]["proj"]["kernel"]).T)
        sd[f"{pre}ff.net.0.proj.bias"] = t(b["ff_in"]["proj"]["bias"])
        sd[f"{pre}ff.net.2.weight"] = t(np.asarray(b["ff_out"]["kernel"]).T)
        sd[f"{pre}ff.net.2.bias"] = t(b["ff_out"]["bias"])
    return sd


def _inputs(with_context):
    rng = np.random.RandomState(0)
    x = rng.randn(2, C, 4, 6).astype(np.float32)
    ctx = rng.randn(2, 5, HEADS * DH if not with_context else CTX).astype(np.float32)
    return x, (ctx if with_context else None)


@pytest.mark.parametrize("with_context", [False, True])
def test_spatial_transformer_matches_jax_blocks(with_context):
    x, ctx = _inputs(with_context)
    jm = JSpatial()
    jctx = None if ctx is None else jnp.asarray(ctx)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jctx)
    rng = np.random.RandomState(2)  # the zero proj_out set off zero
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.2)
        if not np.any(np.asarray(a)) else a, params)
    ref = jm.apply(params, jnp.asarray(x), jctx)
    m = SpatialTransformer(C, HEADS, DH, depth=2, context_dim=CTX if with_context else None)
    m.load_state_dict(_state(params))
    with torch.no_grad():
        out = m(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
    assert out.shape == x.shape
    assert float(np.abs(np.asarray(ref) - x).max()) > 1e-2
    err = float(np.abs(out.numpy() - np.asarray(ref)).max())
    assert err < TOL, err


@pytest.mark.parametrize("with_context", [False, True])
def test_remat_on_and_off_agree(with_context):
    x, ctx = _inputs(with_context)
    torch.manual_seed(0)
    kw = dict(depth=2, context_dim=CTX if with_context else None)
    plain = SpatialTransformer(C, HEADS, DH, **kw)
    with torch.no_grad():
        plain.proj_out.weight.normal_(0, 0.2)
    remat = SpatialTransformer(C, HEADS, DH, remat=True, **kw)
    remat.load_state_dict(plain.state_dict())
    outs, grads = [], []
    for m in (plain, remat):
        xt = torch.tensor(x, requires_grad=True)
        out = m(xt, None if ctx is None else torch.from_numpy(ctx))
        (out * out).sum().backward()
        outs.append(out.detach())
        grads.append([xt.grad] + [p.grad for p in m.parameters()])
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-6)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    c = None if ctx is None else torch.from_numpy(ctx)
    with torch.no_grad():  # no recomputation without gradients
        torch.testing.assert_close(remat(torch.from_numpy(x), c), plain(torch.from_numpy(x), c))


def test_the_jax_module_cannot_run():
    """Gap of the JAX package (ROADMAP Queue 3): its attention arguments are
    out of order, so ``heads`` is None."""
    m = jst.SpatialTransformer(in_channels=C, n_heads=HEADS, d_head=DH)
    with pytest.raises(TypeError, match="NoneType"):
        m.init(jax.random.PRNGKey(0), jnp.zeros((1, C, 4, 4)))
