"""The port's 3D greedy NMS against the JAX package's, on the CPU.

``sphere_max`` must be bit-equal to JAX's (max is exact), in float32 and
int32, at integer and fractional radii; ``non_maximum_suppression_3d``
must give identical scores and (x, y, z) coordinates in the same order,
ties included. The tie-break index is the in-plane one in 3D as in JAX, so
a tie planted across planes resolves as JAX resolves it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.ops import nms as jnms
from topaz_tpu_torch.ops import nms as tnms
from torch_threads import one_torch_thread  # noqa: F401

jax_sphere_max = jax.jit(jnms.sphere_max, static_argnums=(1, 2))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("r", [0, 1, 2.5, 4])
def test_sphere_max_bit_equal_to_jax(r, dtype):
    rng = np.random.default_rng(int(2 * r))
    if dtype == "int32":
        x, init = rng.integers(-999, 999, (9, 11, 13)).astype(np.int32), jnms.INT_NEG
    else:
        x, init = rng.normal(size=(9, 11, 13)).astype(np.float32), -np.inf
    got = tnms.sphere_max(torch.from_numpy(x), r, init).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_sphere_max(jnp.asarray(x), r, init)))


def _volumes():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(10, 14, 12)).astype(np.float32)
    return {
        "random": (x, 2, 1.0, -np.inf),
        "random_threshold_scaled": (x, 2, 1.5, 0.5),
        "quantized_ties": (np.round(x * 2) / 2, 3, 1.0, -1.0),
    }


@pytest.mark.parametrize("name", ["random", "random_threshold_scaled", "quantized_ties"])
def test_non_maximum_suppression_3d_identical_to_jax(name):
    x, r, scale, thr = _volumes()[name]
    ws, wc = jnms.non_maximum_suppression_3d(x, r, scale=scale, threshold=thr)
    ts, tc = tnms.non_maximum_suppression_3d(x, r, scale=scale, threshold=thr, device="cpu")
    assert len(wc) > 3
    np.testing.assert_array_equal(tc, wc)
    np.testing.assert_array_equal(ts, ws)


def test_planted_cross_plane_tie_resolves_as_jax():
    """Two equal peaks one plane apart: the one with the larger in-plane
    index wins, whatever its plane. Two equal peaks at the same in-plane
    index in adjacent planes: both pass the tie-break and are accepted in
    the same round, as in JAX."""
    x = np.zeros((8, 12, 12), np.float32)
    x[2, 5, 6] = 10.0   # in-plane index 66, plane 2
    x[3, 5, 5] = 10.0   # in-plane index 65, plane 3: loses the tie
    x[5, 8, 8] = 9.0
    x[6, 8, 8] = 9.0    # same in-plane index as the one above it
    ws, wc = jnms.non_maximum_suppression_3d(x, 2, threshold=1.0)
    ts, tc = tnms.non_maximum_suppression_3d(x, 2, threshold=1.0, device="cpu")
    np.testing.assert_array_equal(tc, wc)
    np.testing.assert_array_equal(ts, ws)
    assert [tuple(c) for c in tc] == [(6, 5, 2), (8, 8, 6), (8, 8, 5)]
