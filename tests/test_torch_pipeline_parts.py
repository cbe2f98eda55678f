"""The pieces of the port's batched pipeline against the JAX package:
bucket helpers, the fixed-size NMS tables, retry classification and stage
timings. Inputs are made with numpy from a seed and fed to both.

``nms_topk_2d`` / ``nms_topk_batched`` must be identical to JAX's, values,
coordinates (order included) and counts, on maps with -inf regions, a dead
map and exact ties (quantized scores, with -0 and +0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.ops import nms as jnms
from topaz_tpu.utils import batching as jbatching
from topaz_tpu.utils import retry as jretry
from topaz_tpu_torch.ops import nms as tnms
from topaz_tpu_torch.utils import batching as tbatching
from topaz_tpu_torch.utils import profiling
from topaz_tpu_torch.utils import retry as tretry
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shape,step", [((60, 50), 64), ((64, 64), 64), ((479, 463), 64),
                                        ((720, 511), 64), ((7, 1, 33), 16), ((5,), 1)])
def test_round_bucket_equals_jax(shape, step):
    assert tbatching.round_bucket(shape, step) == jbatching.round_bucket(shape, step)


@pytest.mark.parametrize("bucket", [(64, 64), (40, 24), (8, 6, 5)])
def test_valid_mask_equals_jax(bucket):
    rng = np.random.default_rng(len(bucket))
    valid = np.stack([rng.integers(0, e + 1, size=4) for e in bucket], axis=1)
    got = tbatching.valid_mask(bucket, torch.from_numpy(valid))
    want = np.asarray(jbatching.valid_mask(bucket, jnp.asarray(valid)))
    assert got.dtype == torch.bool and got.shape == (4,) + bucket
    np.testing.assert_array_equal(got.numpy(), want)


def test_fetch_async_passes_host_values_through():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = torch.arange(4, dtype=torch.int32)
    got = tbatching.fetch_async(a, None, t)
    np.testing.assert_array_equal(got[0], a)
    assert got[1] is None
    np.testing.assert_array_equal(got[2], t.numpy())


def _maps(seed):
    """(3, 80, 70) quantized maps (exact ties, -0 and +0 among them), with
    -inf regions; the third map is all -inf."""
    rng = np.random.default_rng(seed)
    x = (np.round(rng.normal(size=(3, 80, 70)) * 2) / 2).astype(np.float32)
    x[0, :20, :30] = -np.inf
    x[1, 50:, 40:] = -np.inf
    x[2] = -np.inf
    return x


@pytest.mark.parametrize("r", [3, 6])
def test_nms_topk_batched_identical_to_jax(r):
    x = _maps(r)
    assert (x == 0).any() and (np.signbit(x) & (x == 0)).any()
    k = 400
    want = jnms.nms_topk_batched(jnp.asarray(x), r, -1.0, k)
    got = tnms.nms_topk_batched(torch.from_numpy(x), r, -1.0, k)
    assert int(got[2][2]) == 0 and int(got[2][0]) > 0
    for g, w, name in zip(got, want, ("vals", "coords", "counts")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("r", [3, 6])
def test_nms_topk_2d_identical_to_jax(r):
    x = _maps(r + 10)
    for b in range(3):
        want = jnms.nms_topk_2d(jnp.asarray(x[b]), r, -1.0, 300)
        got = tnms.nms_topk_2d(torch.from_numpy(x[b]), r, -1.0, 300)
        for g, w, name in zip(got, want, ("vals", "coords", "count")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{b} {name}")


MESSAGES = [
    RuntimeError("UNAVAILABLE: socket closed"),
    RuntimeError("DEADLINE_EXCEEDED: operation timed out"),
    ConnectionResetError("peer reset"),
    TimeoutError(),
    RuntimeError("failed to connect to all addresses"),
    RuntimeError("device grant already claimed by pid 123"),
    RuntimeError("INTERNAL: Ran out of memory in memory space hbm"),
    RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
    RuntimeError("INVALID_ARGUMENT: shapes do not match"),
    ValueError("bad radius"),
    RuntimeError("UNAVAILABLE: worker died — Ran out of memory in hbm"),
    RuntimeError("broken pipe while copying"),
]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_retry_classification_agrees_with_jax(i):
    e = MESSAGES[i]
    assert tretry.is_transient_device_error(e) == jretry.is_transient_device_error(e)


@pytest.mark.parametrize("e", [
    torch.cuda.OutOfMemoryError("UNAVAILABLE: CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered (transport)"),
    RuntimeError("CUDA error: device-side assert triggered; try again"),
])
def test_cuda_oom_and_sticky_errors_are_never_transient(e):
    assert not tretry.is_transient_device_error(e)


def test_retry_transient_retries_a_connection_error_once(capsys):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise ConnectionError("connection reset by peer")
        return 7

    assert tretry.retry_transient(flaky, retries=1, base_delay=0.01) == 7
    assert len(calls) == 2
    assert "retrying" in capsys.readouterr().err


def test_retry_transient_never_retries_cuda_oom():
    calls = []

    def oom():
        calls.append(1)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        tretry.retry_transient(oom, retries=3, base_delay=0.01)
    assert len(calls) == 1


def test_stage_records_timings(monkeypatch, capsys):
    monkeypatch.delenv("TOPAZ_PROFILE", raising=False)
    monkeypatch.delenv("TOPAZ_TIMINGS", raising=False)
    assert not profiling.timing_enabled()
    profiling.sync_for_timing((torch.zeros(3),))  # nothing to wait for
    profiling.reset()
    for _ in range(2):
        with profiling.stage("unit/step"):
            sum(range(1000))
    t = profiling.timings()["unit/step"]
    assert t["count"] == 2 and t["total_s"] > 0 and t["mean_ms"] > 0
    monkeypatch.setenv("TOPAZ_TIMINGS", "1")
    assert profiling.timing_enabled()
    with profiling.stage("unit/printed"):
        pass
    assert "[timing] unit/printed" in capsys.readouterr().err
    profiling.reset()
    assert profiling.timings() == {}


def test_profile_session_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("TOPAZ_PROFILE", str(tmp_path / "trace"))
    with profiling.profile_session():
        with profiling.stage("unit/traced"):
            torch.ones(8).sum()
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and "unit/traced" in traces[0].read_text()
    profiling.reset()
