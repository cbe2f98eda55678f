"""The port's ScaledGaussianMixture against the JAX package's, on the CPU.

Both draw their initial hard labels from ``np.random.RandomState(1)`` in the
same order, so they start from one assignment. The fit runs to its
tolerance (the default 100 iterations, done after about 40): scales, means,
variances and weights agree within 1e-5 relative there. The first M step
sums float32 posteriors (numpy row by row, torch in blocks), and while the
two components are still separating (about iteration 20 on these images)
that rounding is amplified to 5e-5 before the fixed point damps it again.
"""

import numpy as np

from topaz_tpu.transform import ScaledGaussianMixture as JSGM
from topaz_tpu_torch.transform import ScaledGaussianMixture
from torch_threads import one_torch_thread  # noqa: F401


def _images(seed=0, n=4, shape=(48, 48)):
    rng = np.random.default_rng(seed)
    X = []
    for s in (0.8, 1.0, 1.2, 1.5)[:n]:
        comp = rng.random(shape) < 0.3
        x = np.where(comp, rng.normal(4.0, 0.3, shape), rng.normal(1.0, 0.3, shape))
        X.append((x * s).astype(np.float32))
    return X


def _check(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-5, atol=0)


def test_fit_and_transform_match_jax():
    X = _images()
    jax_sgm = JSGM(ncomponents=2)
    s_want, p_want = jax_sgm.fit(X, random=np.random.RandomState(1))
    sgm = ScaledGaussianMixture(ncomponents=2, device="cpu")
    s_got, p_got = sgm.fit(X, random=np.random.RandomState(1))
    _check(s_got.numpy(), s_want)
    for name in ("means", "variances", "weights"):
        _check(getattr(sgm, name).numpy(), getattr(jax_sgm, name))
    assert len(p_got) == len(X) and p_got[0].shape == (48 * 48, 2)
    np.testing.assert_allclose(p_got[0].numpy(), p_want[0], rtol=0, atol=1e-5)

    # transform on rescaled images under the fitted mixture
    Y = [x * f for x, f in zip(_images(seed=1), (1.0, 2.0, 0.7, 1.0))]
    t_want, q_want = jax_sgm.transform(Y, niters=5)
    t_got, q_got = sgm.transform(Y, niters=5)
    _check(t_got.numpy(), t_want)
    np.testing.assert_allclose(q_got.numpy(), q_want, rtol=1e-5, atol=1e-12)
