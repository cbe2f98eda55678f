"""The port's disk max-filter and greedy NMS against the JAX package.

The plain ``disk_max`` must be bit-equal to JAX's lax ``disk_max`` and to
the Pallas kernel run in interpret mode (max is exact), and
``non_maximum_suppression`` must give identical scores and coordinates,
ties included. The CUDA kernel is held bit-equal to the plain version on
the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.ops import nms as jnms
from topaz_tpu.ops.nms_pallas import disk_max_pallas
from topaz_tpu_torch.ops import disk_max as kernel
from topaz_tpu_torch.ops import nms as tnms
from torch_threads import one_torch_thread  # noqa: F401

# the lax reference, jitted once per (r, init): eager it dispatches ~3r ops
jax_disk_max = jax.jit(jnms.disk_max, static_argnums=(1, 2))


def _input(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-999, 999, shape).astype(np.int32), jnms.INT_NEG
    return rng.normal(size=shape).astype(np.float32), -np.inf


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("shape", [(100, 130), (300, 200), (64, 64), (2, 90, 70)])
@pytest.mark.parametrize("r", [3, 7, 14])
def test_plain_disk_max_bit_equal_to_jax_and_pallas(r, shape, dtype):
    x, init = _input(shape, dtype, seed=r)
    port = tnms.disk_max(torch.from_numpy(x), r, init).numpy()
    lax_out = np.asarray(jax_disk_max(jnp.asarray(x), r, init))
    pallas = np.asarray(disk_max_pallas(jnp.asarray(x), r, init, interpret=True))
    np.testing.assert_array_equal(port, lax_out)
    np.testing.assert_array_equal(port, pallas)


@pytest.mark.parametrize("r", [0, 1, 5, 20])
def test_wrapper_takes_the_plain_version_for_cpu_tensors(r):
    x, init = _input((40, 50), "float32", seed=r)
    before = kernel.launches
    out = kernel.disk_max(torch.from_numpy(x), r, init).numpy()
    assert kernel.launches == before
    np.testing.assert_array_equal(out, np.asarray(jax_disk_max(jnp.asarray(x), r, init)))


def _maps():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(96, 80)).astype(np.float32)
    return {
        "random": (x, 5, -np.inf),
        "random_threshold": (x, 9, 0.5),
        "quantized_ties": (np.round(x * 2) / 2, 6, -1.0),
        "coarse_ties": (np.round(x).astype(np.float32), 4, -np.inf),
        "constant": (np.zeros((30, 40), np.float32), 3, -1.0),
        "smooth_peaks": ((np.cos(np.arange(70)[:, None] / 5.0)
                          * np.sin(np.arange(90)[None] / 7.0)).astype(np.float32),
                         8, -np.inf),
    }


@pytest.mark.parametrize("name", ["random", "random_threshold", "quantized_ties",
                                  "coarse_ties", "constant", "smooth_peaks"])
def test_non_maximum_suppression_identical_to_jax(name):
    x, r, thr = _maps()[name]
    js, jc = jnms.non_maximum_suppression(x, r, threshold=thr)
    ts, tc = tnms.non_maximum_suppression(x, r, threshold=thr, device="cpu")
    assert len(ts) > 0
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tc, jc)


def test_batched_mask_matches_per_image():
    x, _ = _input((3, 50, 60), "float32", seed=3)
    t = torch.from_numpy(x)
    batched = tnms.nms_mask_2d(t, 6, -0.5)
    for i in range(3):
        torch.testing.assert_close(batched[i], tnms.nms_mask_2d(t[i].contiguous(), 6, -0.5))
        np.testing.assert_array_equal(
            batched[i].numpy(), np.asarray(jnms.nms_mask_2d(jnp.asarray(x[i]), 6, -0.5)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("shape,r", [((512, 512), 14), ((3, 300, 200), 7),
                                     ((33, 70), 0), ((64, 80), 96),
                                     ((70, 33), 100), ((40, 50), 120)])
def test_cuda_kernel_bit_equal_to_plain(cuda_device, dtype, shape, r):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    if dtype == torch.float32:
        x, init = torch.randn(shape, device=cuda_device, generator=g), tnms.NEG
    else:
        x = torch.randint(-999, 999, shape, device=cuda_device, generator=g, dtype=dtype)
        init = tnms.INT_NEG
    before = kernel.launches
    out = kernel.disk_max(x, r, init)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(out, tnms.disk_max(x, r, init))
