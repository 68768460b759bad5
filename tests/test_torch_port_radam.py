"""The port's ``make_radam`` against the JAX package's (``optax.radam`` after
``optax.add_decayed_weights``), CPU.

RAdam switches from the bias-corrected momentum to the rectified adaptive
update once rho_t >= 5, which at b2 = 0.999 is step 6: every run here goes
to step 10 or more, so the switch is inside it. Bar: parameters within 1e-6
relative to their scale after every step (float32 updates in another
order; the step's scalars are computed as optax computes them, in float32).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from versband_tpu.train.state import make_radam as jax_radam
from versband_tpu_torch.train.state import RAdamOptimizer, TrainState, make_radam


def _run(lr, betas, eps, wd, steps, seed=0, schedule=None):
    rng = np.random.RandomState(seed)
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) * (1 + i % 3) for i in range(steps)]
    m = torch.nn.Linear(5, 6, bias=False)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w0))
    state = TrainState(m, make_radam(schedule or lr, betas, eps, wd))
    tx = jax_radam(schedule or lr, betas, eps, wd)
    p = jnp.asarray(w0)
    opt = tx.init(p)
    errs = []
    for g in grads:
        m.weight.grad = torch.from_numpy(g.copy())
        assert state.apply_gradients()
        u, opt = tx.update(jnp.asarray(g), opt, p)
        p = optax.apply_updates(p, u)
        ref = np.asarray(p)
        errs.append(np.abs(m.weight.detach().numpy() - ref).max() / np.abs(ref).max())
    return errs, state


@pytest.mark.parametrize("lr,betas,eps,wd", [(1e-2, (0.9, 0.999), 1e-8, 0.0),
                                             (1e-4, (0.5, 0.9), 1e-6, 0.0),
                                             (5e-3, (0.9, 0.999), 1e-6, 1e-2)],
                         ids=["defaults", "pwg_disc", "l2_decay"])
def test_radam_matches_optax(lr, betas, eps, wd):
    errs, state = _run(lr, betas, eps, wd, steps=12)
    assert max(errs) <= 1e-6, errs
    assert state.updates == 12 and state.step == 12


def test_rectification_switches_at_step_6():
    """rho_t as optax computes it (float32, b^t by squaring) crosses 5
    between steps 5 and 6 at b2 = 0.999."""
    rho = [RAdamOptimizer.scalars(t, 0.9, 0.999)[0] for t in range(1, 9)]
    assert [r >= 5 for r in rho] == [False] * 5 + [True] * 3
    assert RAdamOptimizer.scalars(6, 0.9, 0.999)[1] == pytest.approx(0.0255229, rel=1e-5)


def test_schedule_and_state_dict_round_trip():
    errs, state = _run(None, (0.9, 0.999), 1e-8, 0.0, steps=10,
                       schedule=lambda count: 1e-2 / (1 + count))
    assert max(errs) <= 1e-6
    sd = state.state_dict()
    m2 = torch.nn.Linear(5, 6, bias=False)
    s2 = TrainState(m2, make_radam(1e-2))
    s2.load_state_dict(sd)
    st = s2.optimizer.state[s2.params[0]]
    assert st["step"] == 10 and torch.equal(st["mu"], state.optimizer.state[state.params[0]]["mu"])
