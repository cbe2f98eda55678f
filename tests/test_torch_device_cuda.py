"""The card's copies through page-locked memory: ``transfer.as_device_tensor``
staging host data through the card's ring of pinned slots,
``transfer.to_host`` fetching into pinned buffers, against the plain
(pageable) copies they replace, bit for bit; and ``transfer.fetch_later``
holding its tensor's values from before later work.

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_device_cuda.py``. Without a card it skips."""

import contextlib

import numpy as np
import pytest
import torch

from topaz_tpu_torch import denoise, transfer
from topaz_tpu_torch.denoise import Denoise, Denoise3D, denoise_image

COUNTERS = ("staged_uploads", "staged_bytes", "plain_uploads", "pinned_fetches")
N = transfer.STAGE_MIN_BYTES // 4   # the fewest values staged
SLOT = transfer.SLOT_BYTES // 4     # values a chunk


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: copies between pinned host memory and the card")
    return torch.device("cuda", torch.cuda.current_device())


def _counted(fn):
    before = {c: getattr(transfer, c) for c in COUNTERS}
    out = fn()
    return out, {c: getattr(transfer, c) - before[c] for c in COUNTERS}


def _random(dtype, n, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return (rng.normal(size=n) * 1e3).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=n, endpoint=True, dtype=dtype)


def _plain(x, dev):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)


def _same_bits(a, b):
    a, b = (torch.as_tensor(t) for t in (a, b))
    return a.shape == b.shape and torch.equal(a.cpu().view(torch.int32),
                                              b.cpu().view(torch.int32))


@contextlib.contextmanager
def _pageable(monkeypatch):
    """The copies as they were: a float32 host copy uploaded pageable, and
    ``.cpu().numpy()``."""
    with monkeypatch.context() as m:
        m.setattr(transfer, "STAGE_MIN_BYTES", np.inf)
        m.setattr(denoise, "to_host", lambda t: t.cpu().numpy())
        yield


@pytest.mark.cuda
@pytest.mark.parametrize("n,route", [(N - 1, "plain"), (N, "staged"), (SLOT + 12345, "staged"),
                                     (4 * SLOT + 1, "staged")])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16, np.uint8])
def test_a_staged_upload_is_bit_equal_to_the_plain_one(card, n, route, dtype):
    x = _random(dtype, n, seed=n)
    got, counted = _counted(lambda: transfer.as_device_tensor(x, card))
    assert got.device == card and got.dtype == torch.float32
    assert _same_bits(got, _plain(x, card))
    staged = route == "staged"
    assert counted == {"staged_uploads": int(staged), "staged_bytes": 4 * n if staged else 0,
                       "plain_uploads": int(not staged), "pinned_fetches": 0}
    t = torch.from_numpy(x)  # a CPU tensor takes the same route
    got, counted = _counted(lambda: transfer.as_device_tensor(t, card))
    assert _same_bits(got, _plain(x, card)) and counted["staged_uploads"] == int(staged)


@pytest.mark.cuda
def test_back_to_back_uploads_never_rewrite_a_slot_under_its_copy(card):
    """Each input is more chunks than the ring has slots, and every copy
    queues behind ~0.1 s of device work: a slot written again before its
    copy ran would show in the outputs."""
    xs = [_random(np.float32, 4 * SLOT + 777 * k, seed=k) for k in range(3)]
    torch.cuda._sleep(200_000_000)
    outs = [transfer.as_device_tensor(x, card) for x in xs]
    for x, out in zip(xs, outs):
        assert _same_bits(out, torch.from_numpy(x))


@pytest.mark.cuda
def test_denoise_image_comes_back_pinned_and_equal_to_the_pageable_route(card, monkeypatch):
    model = Denoise("unet", device=card)
    mic = np.random.default_rng(1).normal(size=(1024, 1024)).astype(np.float32)
    got, counted = _counted(lambda: denoise_image(mic, [model]))
    assert counted == {"staged_uploads": 1, "staged_bytes": mic.nbytes, "plain_uploads": 0,
                       "pinned_fetches": 1}
    assert torch.from_numpy(got).is_pinned() and got.flags.c_contiguous
    with _pageable(monkeypatch):
        want, counted = _counted(lambda: denoise_image(mic, [model]))
    assert counted["staged_uploads"] == 0 and counted["pinned_fetches"] == 0
    assert not torch.from_numpy(want).is_pinned()
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("patch_size,padding,route", [(32, 16, "resident"), (0, 0, None)])
def test_denoise3d_comes_back_pinned_and_equal_to_the_pageable_route(card, monkeypatch,
                                                                    patch_size, padding, route):
    vol = np.random.default_rng(2).normal(size=(64, 72, 60)).astype(np.float32)  # > 1 MiB
    den = Denoise3D.from_arch("unet", device=card, nf=8, base_width=7, seed=1)
    den.last_route = None
    kw = dict(patch_size=patch_size, padding=padding, verbose=False)
    got, counted = _counted(lambda: den.denoise(vol, **kw))
    assert den.last_route == route
    assert counted == {"staged_uploads": 1, "staged_bytes": vol.nbytes, "plain_uploads": 0,
                       "pinned_fetches": 1}
    assert torch.from_numpy(got).is_pinned() and got.flags.c_contiguous
    with _pageable(monkeypatch):
        want = den.denoise(vol, **kw)
    assert _same_bits(got, want)


@pytest.mark.cuda
def test_warm_copies_allocate_no_pinned_memory(card):
    """After the first staged upload (the ring) and the first fetch of a size
    (a block of the caching host allocator, back at the array's drop),
    uploads and fetches allocate no pinned memory."""
    x = _random(np.float64, 3 * SLOT + 5)
    transfer.to_host(transfer.as_device_tensor(x, card))
    ring = transfer.staging_ring(card)
    slots = [s.host.data_ptr() for s in ring.slots]
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    for _ in range(4):
        out = transfer.to_host(transfer.as_device_tensor(x, card))
        assert _same_bits(out, np.array(x, dtype=np.float32))
        del out
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
    assert transfer.staging_ring(card) is ring
    assert [s.host.data_ptr() for s in ring.slots] == slots


@pytest.mark.cuda
def test_a_lagged_fetch_holds_the_values_from_before_later_kernels(card):
    """``fetch_later`` returns while its copy is still queued behind ~0.1 s
    of device work; a kernel queued after it that overwrites the tensor does
    not reach the fetched values, and ``result`` waits for the copy."""
    want = torch.arange(1 << 20, dtype=torch.float32)
    t = want.to(card)
    torch.cuda._sleep(200_000_000)
    pending = transfer.fetch_later(t)
    assert not torch.cuda.current_stream(card).query()  # the copy has not run
    t.fill_(-1.0)
    got = pending.result()
    assert got.is_pinned() and _same_bits(got, want)
    assert _same_bits(t, torch.full_like(want, -1.0))
