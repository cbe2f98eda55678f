"""The port's PU objectives and optimizers against the JAX package's.

The same scores and labels (numpy, from a seed) go through both objectives:
the loss, every metric and d loss / d score agree to rtol 2e-5, atol 2e-6
(float32; ``torch.lgamma`` and ``jax.scipy.special.gammaln`` and the
reductions round differently in the last bits). Batches of 16 with 0, 1, 5
and 16 positives. The optimizers take the same gradients as optax for five
steps; the parameters (of order 1) agree to rtol 1e-5, atol 1e-6, a few
float32 ulps at 1 (optax's and the port's update rules are the same
formulas, rounded in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from topaz_tpu.train import methods as jmethods
from topaz_tpu.train import trainer as jtrainer
from topaz_tpu_torch.train import methods as tmethods
from topaz_tpu_torch.train import trainer as ttrainer
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-6)

CASES = [
    ("PN", 0.05, {}),
    ("PN", None, {}),
    ("GE-binomial", 0.03, {}),
    ("GE-binomial", 0.03, {"entropy_penalty": 0.1, "slack": 2.0}),
    ("GE-KL", 0.03, {}),
    ("GE-KL", 0.03, {"momentum": 0.5, "entropy_penalty": 0.2}),
    ("PU", 0.05, {}),
    ("PU", 0.05, {"beta": 0.5}),
]


def _run_jax(fn, score, y, state):
    def loss(s):
        value, new_state, metrics = fn(s, jnp.asarray(y), state)
        return value, (new_state, metrics)

    (value, (new_state, metrics)), grad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(score))
    return float(value), new_state, {k: float(v) for k, v in metrics.items()}, np.asarray(grad)


def _run_torch(fn, score, y, state):
    s = torch.tensor(score, requires_grad=True)
    value, new_state, metrics = fn(s, torch.from_numpy(y), state)
    (grad,) = torch.autograd.grad(value, s)
    return (float(value.detach()), new_state,
            {k: float(v.detach()) for k, v in metrics.items()}, grad.numpy())


@pytest.mark.parametrize("method,pi,kw", CASES)
def test_objectives_match_jax(method, pi, kw):
    rng = np.random.default_rng(0)
    jfn, jheader, jsplit = jmethods.make_loss_fn(method, pi, **kw)
    tfn, theader, tsplit = tmethods.make_loss_fn(method, pi, **kw)
    assert (theader, tsplit) == (jheader, jsplit)
    jstate, tstate = jmethods.init_method_state(pi), tmethods.init_method_state(pi)
    for n_pos in (0, 1, 5, 16, 3):
        score = rng.normal(0, 2, 16).astype(np.float32)
        y = np.zeros(16, np.float32)
        y[rng.permutation(16)[:n_pos]] = 1
        want = _run_jax(jfn, score, y, jstate)
        got = _run_torch(tfn, score, y, tstate)
        np.testing.assert_allclose(got[0], want[0], **TOL)
        assert sorted(got[2]) == sorted(want[2])
        for k in want[2]:
            np.testing.assert_allclose(got[2][k], want[2][k], err_msg=k, **TOL)
        np.testing.assert_allclose(got[3], want[3], **TOL)
        # GE-KL's running expectation carries over to the next batch
        jstate, tstate = want[1], got[1]
        np.testing.assert_allclose(float(tstate.running_expectation),
                                   float(jstate.running_expectation), **TOL)


def test_bce_with_logits_matches_torch():
    s = torch.linspace(-30, 30, 101)
    for t in (0.0, 1.0):
        want = torch.nn.functional.binary_cross_entropy_with_logits(
            s, torch.full_like(s, t), reduction="none")
        torch.testing.assert_close(tmethods.bce_with_logits(s, t), want)


@pytest.mark.parametrize("kind,momentum", [("adam", 0.0), ("adagrad", 0.0), ("sgd", 0.0),
                                           ("sgd", 0.9), ("rmsprop", 0.0)])
def test_optimizers_match_optax(kind, momentum):
    rng = np.random.default_rng(1)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    # a zero entry stays zero under adagrad's where(acc > 0)
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(5)]
    grads[0][1][0] = 0.0
    jopt = jtrainer.make_optimizer(1e-2, kind, momentum=momentum)
    jparams = [jnp.asarray(p) for p in params0]
    jstate = jopt.init(jparams)
    tparams = [torch.tensor(p) for p in params0]
    topt = ttrainer.make_optimizer(tparams, 1e-2, kind, momentum=momentum)
    for g in grads:
        updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.step([torch.tensor(x) for x in g])
        for got, want in zip(tparams, jparams):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrainer.make_optimizer(tparams, 1e-2, "lbfgs")
