"""``flash_attention_sharded`` in the port (``versband_tpu_torch/ops/
flash_attention.py``) over gloo on the CPU, mirroring JAX
``tests/test_flash_attention.py:150-205`` through the plain version: one
spawn of four ranks (``tests/torch_port_tp_worker.py``) on a (2, 2) mesh,
batch rows over ``data`` and heads over ``model``.

* The output matches masked SDPA (the port's ``sdpa``, and JAX's
  ``flash_attention_sharded`` on ``make_mesh(2, 2)``, which runs the
  interpreted Pallas kernel) within 2e-5, as the JAX test's bar.
* The gradient of sum(out^2) matches the unsharded ``flash_attention``'s
  within 2e-5.
* Three heads on a model axis of 2 fall back to the unsharded kernel (no
  collective) and still match SDPA.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from versband_tpu.ops.flash_attention import flash_attention_sharded as j_sharded
from versband_tpu.parallel import make_mesh as j_make_mesh
from versband_tpu_torch.nn.core import sdpa
from versband_tpu_torch.ops.flash_attention import flash_attention
import torch_port_tp_worker as worker

WORLD = 4
B, Tq, H, D = 4, 48, 4, 32
TOL = 2e-5


def _inputs():
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, Tq, H, D)).astype(np.float32))
               for _ in range(3))
    kv_len = torch.tensor([48, 31, 40, 7], dtype=torch.int32)
    odd = tuple(torch.from_numpy(rng.standard_normal((4, 16, 3, D)).astype(np.float32))
                for _ in range(3))
    return q, k, v, kv_len, odd


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = tmp_path_factory.mktemp("flash_sharded")
    q, k, v, kv_len, odd = _inputs()
    torch.save({"kind": "flash", "q": q, "k": k, "v": v, "kv_len": kv_len, "odd": odd},
               root / "inputs.pt")
    ranks = mp.start_processes(worker.main, args=(WORLD, str(root / "rendezvous"),
                                                  str(root / "inputs.pt"), str(root)),
                               nprocs=WORLD, join=False, start_method="spawn")
    mesh = j_make_mesh(2, 2, devices=jax.devices()[:4])
    jout = jax.jit(lambda q, k, v, n: j_sharded(q, k, v, n, mesh=mesh))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, kv_len)))
    while not ranks.join(timeout=300):
        pass
    return {"jax": np.asarray(jout),
            "ranks": [torch.load(root / f"rank{r}.pt", weights_only=False)
                      for r in range(WORLD)]}


def _mask(kv_len, Tk):
    return torch.arange(Tk)[None, :] < kv_len[:, None].long()


def test_sharded_matches_sdpa_and_jax(spawned):
    q, k, v, kv_len, _ = _inputs()
    ref = sdpa(q, k, v, _mask(kv_len, Tq))
    for r in spawned["ranks"]:
        torch.testing.assert_close(r["out"], ref, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(r["out"].numpy(), spawned["jax"], atol=TOL, rtol=TOL)


def test_sharded_grad_matches_unsharded(spawned):
    q, k, v, kv_len, _ = _inputs()
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    (flash_attention(q, k, v, kv_len=kv_len) ** 2).sum().backward()
    for r in spawned["ranks"]:
        for got, t in zip(r["grads"], (q, k, v)):
            torch.testing.assert_close(got, t.grad, atol=TOL, rtol=TOL)


def test_sharded_falls_back_on_indivisible_axes(spawned):
    _, _, _, _, odd = _inputs()
    ref = sdpa(*odd, scale=1.0 / math.sqrt(D))
    for r in spawned["ranks"]:
        assert r["fallback_reduces"] == 0
        torch.testing.assert_close(r["fallback"], ref, atol=TOL, rtol=TOL)
