"""The port's optimizer == optax's `make_optimizer` of the JAX package.

Identical synthetic gradient sequences go to both for 6 steps, with 2
steps per epoch and a milestone at epoch 1 (so the learning rate drops by
GAMMA mid-run): adam, sgd with momentum and weight decay, rmsprop (optax's
decay 0.9 with eps inside the square root, where torch.optim.RMSprop would
differ), and BATCH_MUL=2 (optax.MultiSteps: the mean of two gradients every
second step, with the schedule counting the inner updates).  The
parameters must agree to rtol 1e-6: both sides do the same f32 arithmetic
up to operation order.
"""

import io

import numpy as np
import pytest
import jax.numpy as jnp
import optax
import torch

from epipolar_transformers_tpu.config import Config, update_from_dict
from epipolar_transformers_tpu.engine.solver import make_optimizer as jax_make_optimizer
from epipolar_transformers_tpu_torch.engine.solver import Optimizer, make_lr_schedule

STEPS = 6
STEPS_PER_EPOCH = 2


def _cfg(**solver):
    return update_from_dict(Config(), {"SOLVER": {
        "BASE_LR": 0.01, "STEPS": (1,), "GAMMA": 0.1, **solver}})


# rmsprop runs on gradients of ~1e-4, where nu ~ 1e-9 is near eps and
# sqrt(nu + eps) differs from sqrt(nu) + eps by far more than the tolerance
@pytest.mark.parametrize("solver,grad_scale", [
    (dict(OPTIMIZER="adam"), 1.0),
    (dict(OPTIMIZER="sgd", MOMENTUM=0.9, WEIGHT_DECAY=1e-2), 1.0),
    (dict(OPTIMIZER="rmsprop"), 1e-4),
    (dict(OPTIMIZER="adam", BATCH_MUL=2, WEIGHT_DECAY=1e-3), 1.0),
], ids=["adam", "sgd_momentum_wd", "rmsprop", "adam_batch_mul2"])
def test_optimizer_matches_optax(rng, solver, grad_scale):
    cfg = _cfg(**solver)
    shapes = [(3, 4), (5,)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * grad_scale).astype(np.float32) for s in shapes]
             for _ in range(STEPS)]

    tx = jax_make_optimizer(cfg, STEPS_PER_EPOCH)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    s = cfg.SOLVER
    opt = Optimizer(params, s.OPTIMIZER, make_lr_schedule(cfg, STEPS_PER_EPOCH),
                    momentum=s.MOMENTUM, weight_decay=s.WEIGHT_DECAY, batch_mul=s.BATCH_MUL)
    for g in grads:
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    assert opt.count == STEPS // s.BATCH_MUL
    for got, want in zip(params, jparams):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), rtol=1e-6,
                                   atol=1e-7)


def test_schedule_is_multistep_per_epoch():
    schedule = make_lr_schedule(_cfg(OPTIMIZER="sgd", STEPS=(1, 2)), STEPS_PER_EPOCH)
    assert [schedule(n) for n in range(6)] == pytest.approx(
        [0.01, 0.01, 1e-3, 1e-3, 1e-4, 1e-4])


def test_optimizer_state_round_trips(rng):
    """A checkpointed optimizer resumes with the same moments and count."""
    cfg = _cfg(OPTIMIZER="adam", BATCH_MUL=2)
    make = lambda p: Optimizer(p, "adam", make_lr_schedule(cfg, 1), batch_mul=2)  # noqa: E731
    a = [torch.nn.Parameter(torch.zeros(4))]
    opt = make(a)
    for _ in range(3):
        a[0].grad = torch.from_numpy(rng.randn(4).astype(np.float32))
        opt.step()
    b = [torch.nn.Parameter(a[0].detach().clone())]
    resumed = make(b)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    resumed.load_state_dict(torch.load(buf, weights_only=True))
    assert resumed.count == opt.count == 1
    g = torch.from_numpy(rng.randn(4).astype(np.float32))
    for p, o in ((a[0], opt), (b[0], resumed)):
        p.grad = g.clone()
        o.step()
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
