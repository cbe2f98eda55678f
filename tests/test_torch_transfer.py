"""``transfer.as_device_tensor`` and ``transfer.to_host`` on the CPU: the
values, dtype and device each host input comes out with, the route it
takes to a card (staged through the card's ring of pinned slots, or plain),
the staging ring's chunks and casts, and the module counters. The card's
own copies are in ``test_torch_device_cuda.py``."""

import sys
import threading

import numpy as np
import pytest
import torch

from topaz_tpu_torch import transfer
from torch_staging import CARD, SLOT, cpu_staging  # noqa: F401

COUNTERS = ("staged_uploads", "staged_bytes", "plain_uploads", "pinned_fetches")
SHAPE = (515, 517)  # 266,255 values: 1 MiB and more as float32, 2.66 slots


def _random(dtype, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return (rng.normal(size=shape) * 1e3).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, endpoint=True, dtype=dtype)


def _read_only():
    x = _random(np.float32, seed=1)
    x.setflags(write=False)
    return x


# name -> (input, its route to a card)
CASES = {
    "float32": (lambda: _random(np.float32), "staged"),
    "float64": (lambda: _random(np.float64), "staged"),
    "int16": (lambda: _random(np.int16), "staged"),
    "uint8": (lambda: _random(np.uint8), "staged"),
    "read_only": (_read_only, "staged"),
    "non_contiguous": (lambda: _random(np.float32, (515, 1034))[:, ::2], "plain"),
    "tensor": (lambda: torch.from_numpy(_random(np.float64, seed=2)), "staged"),
}


def _want(x):
    return np.array(x.numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float32)


def _counted(fn):
    before = {c: getattr(transfer, c) for c in COUNTERS}
    out = fn()
    return out, {c: getattr(transfer, c) - before[c] for c in COUNTERS}


def _bits_equal(got: torch.Tensor, want: np.ndarray):
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_a_cpu_target_keeps_todays_copy(case):
    make, _ = CASES[case]
    x = make()
    got, counted = _counted(lambda: transfer.as_device_tensor(x, "cpu"))
    _bits_equal(got, _want(x))
    assert counted == dict.fromkeys(COUNTERS, 0)  # nothing goes to a card
    assert transfer._route(x, torch.device("cpu")) is None


@pytest.mark.parametrize("case", list(CASES))
def test_host_data_takes_its_route_to_a_card(case, cpu_staging):
    make, route = CASES[case]
    x = make()
    assert transfer._route(x, CARD) == route
    # on the CPU, tensors are device data: route them as arrays
    src = x.numpy() if isinstance(x, torch.Tensor) else x
    got, counted = _counted(lambda: transfer.as_device_tensor(src, "cpu"))
    _bits_equal(got, _want(x))
    n = int(np.prod(x.shape))
    assert counted == {"staged_uploads": int(route == "staged"),
                       "staged_bytes": 4 * n if route == "staged" else 0,
                       "plain_uploads": int(route == "plain"), "pinned_fetches": 0}


@pytest.mark.parametrize("make,route", [
    (lambda: np.zeros(2 ** 18, np.float32), "staged"),        # 1 MiB exactly
    (lambda: np.zeros(2 ** 18 - 1, np.float32), "plain"),     # under it
    (lambda: np.zeros(2 ** 18, np.uint8), "staged"),          # 1 MiB as float32
    (lambda: np.zeros(2 ** 18, np.complex64), "plain"),       # not real numbers
    (lambda: np.zeros((2 ** 10, 2 ** 9), order="F"), "plain"),
    (lambda: [[0.0] * 4] * 4, "plain"),
    (lambda: torch.zeros(2 ** 18, requires_grad=True), "plain"),
    (lambda: torch.zeros(2 ** 18, device="meta"), None),      # device data
])
def test_the_route_follows_size_layout_and_place(make, route):
    assert transfer._route(make(), CARD) == route


@pytest.mark.parametrize("n", [1, SLOT - 1, SLOT, SLOT + 1, 2 * SLOT, 2 * SLOT + 7,
                               5 * SLOT + 3])
@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.float16, np.bool_])
def test_the_ring_casts_every_chunk_as_numpy(n, dtype, monkeypatch):
    monkeypatch.setattr(transfer, "_PART", 4096)  # a chunk's cast split in 3
    ring = transfer.StagingRing(pinned=False, slots=2, slot_bytes=4 * SLOT, threads=3)
    rng = np.random.default_rng(n)
    scale = 2.0 ** 30 if dtype in (np.float64, np.int64) else 1e3  # these two round
    x = (rng.normal(size=n) * scale).astype(dtype)
    out = torch.full((n,), np.nan)
    ring.upload(x, out)
    _bits_equal(out, np.array(x, dtype=np.float32))
    t = torch.from_numpy(x)
    out = torch.full((n,), np.nan)
    ring.upload(t, out)
    ring.close()
    _bits_equal(out, np.array(x, dtype=np.float32))


def test_threads_share_one_ring_and_lose_no_count(cpu_staging):
    """More uploading threads than cores, under a short switch interval:
    every output is its own input's, and the counters add up exactly."""
    threads, each = 16, 4
    inputs = [_random(np.float64, (300, 900), seed=s) for s in range(threads)]
    bad = []

    def work(x):
        for _ in range(each):
            if not np.array_equal(transfer.as_device_tensor(x, "cpu").numpy(),
                                  x.astype(np.float32)):
                bad.append(x)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run():
            pool = [threading.Thread(target=work, args=(x,)) for x in inputs]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in pool)

        _, counted = _counted(run)
    finally:
        sys.setswitchinterval(interval)
    assert not bad
    assert counted["staged_uploads"] == threads * each
    assert counted["staged_bytes"] == threads * each * 4 * 300 * 900


def test_to_host_gives_a_cpu_tensor_its_own_memory():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    got, counted = _counted(lambda: transfer.to_host(t))
    assert isinstance(got, np.ndarray) and np.shares_memory(got, t.numpy())
    assert counted == dict.fromkeys(COUNTERS, 0)
