"""The batched pipeline's raw frames: reading a micrograph straight into a
reused host frame (``io/mrc.readinto``, ``MicrographPipeline._read_raw``)
and the frames' lifetime in ``transfer.FramePool``.

A one-section float32 MRC is read into a pool frame with no copy; every
other image is loaded as before and copied in once; both give
``load_image``'s values bit for bit. A frame goes back to the pool only
after the batch that holds it has been uploaded (or when it can no longer
be: a failed read, a failed batch, a consumer that stops early), is never
handed out twice at once, and the pool stays within its bound. Tiny
micrographs on the CPU, where frames are plain host tensors; no JAX."""

import threading

import numpy as np
import pytest
import torch
from PIL import Image

from topaz_tpu_torch import transfer
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.io.image import load_image
from topaz_tpu_torch.pipeline import MicrographPipeline
from torch_threads import one_torch_thread  # noqa: F401

# the three cameras of benchmark/traffic/mixed_session.json, 16 times smaller
GEOMETRIES = [(4096 // 16, 4096 // 16), (4092 // 16, 5760 // 16), (3710 // 16, 3838 // 16)]
EXT = bytes(range(96))  # an extended header: the data starts 96 bytes later


def _counts():
    return transfer.direct_reads, transfer.fallback_reads, transfer.allocations


def _write_mode(path, x, dtype, ext=b""):
    header = mrc.default_header((1,) + x.shape, dtype=dtype, exthd_size=len(ext))
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(ext)
        f.write(x.astype(dtype).tobytes())
    return str(path)


@pytest.mark.parametrize("ext", [b"", EXT], ids=["next0", "next96"])
@pytest.mark.parametrize("shape", GEOMETRIES)
def test_a_float32_mrc_is_read_straight_into_a_frame(tmp_path, shape, ext):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    path = str(tmp_path / "m.mrc")
    mrc.write(path, x, extended_header=ext)
    pool = transfer.FramePool(pinned=False)
    lease = pool.lease(4)
    before = _counts()
    got = MicrographPipeline._read_raw(path, lease)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), load_image(path))
    assert _counts() == (before[0] + 1, before[1], before[2] + 1)
    lease.give(got)
    assert MicrographPipeline._read_raw(path, lease) is got  # reused, not allocated
    assert _counts()[2] == before[2] + 1


def _fallback_files(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 300, size=(61, 83)).astype(np.float32)
    out = {
        "mode1": _write_mode(tmp_path / "m1.mrc", x, np.int16),
        "mode6": _write_mode(tmp_path / "m6.mrc", np.abs(x), np.uint16, ext=EXT),
        "mode12": _write_mode(tmp_path / "m12.mrc", x / 300, np.float16),
        "tiff": str(tmp_path / "m.tiff"),
        "npy": str(tmp_path / "m.npy"),
    }
    Image.fromarray(x).save(out["tiff"], "tiff")
    np.save(out["npy"], x)
    return out


@pytest.mark.parametrize("kind", ["mode1", "mode6", "mode12", "tiff", "npy"])
def test_other_images_are_loaded_and_copied_into_a_frame(tmp_path, kind):
    path = _fallback_files(tmp_path)[kind]
    pool = transfer.FramePool(pinned=False)
    before = _counts()
    got = MicrographPipeline._read_raw(path, pool.lease(4))
    assert isinstance(got, torch.Tensor)
    want = np.asarray(load_image(path), dtype=np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _counts() == (before[0], before[1] + 1, before[2] + 1)


def test_at_the_bound_a_read_falls_back_to_a_pageable_array(tmp_path):
    path = str(tmp_path / "m.mrc")
    x = np.random.default_rng(1).normal(size=(40, 50)).astype(np.float32)
    mrc.write(path, x)
    pool = transfer.FramePool(pinned=False)
    lease = pool.lease(1)
    held = MicrographPipeline._read_raw(path, lease)
    before = _counts()
    got = MicrographPipeline._read_raw(path, lease)
    assert isinstance(got, np.ndarray) and got.flags.writeable
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(held.numpy(), x)
    assert _counts() == (before[0], before[1] + 1, before[2])
    assert MicrographPipeline._read_raw(path, None).flags.writeable  # no pool: as before


@pytest.mark.parametrize("cut", ["data", "header"])
def test_a_truncated_file_raises_and_gives_its_frame_back(tmp_path, cut):
    whole = str(tmp_path / "whole.mrc")
    mrc.write(whole, np.ones((64, 64), np.float32), extended_header=EXT)
    data = open(whole, "rb").read()
    path = tmp_path / "short.mrc"
    path.write_bytes(data[:-100] if cut == "data" else data[:700])
    pool = transfer.FramePool(pinned=False)
    with pytest.raises(ValueError, match="ends after|shorter than an MRC header"):
        MicrographPipeline._read_raw(str(path), pool.lease(4))
    assert pool.idle() == pool.frames == (1 if cut == "data" else 0)
    with open(path, "rb") as f, pytest.raises(ValueError):
        header = mrc.read_header(f)
        mrc.readinto(f, header, np.empty((64, 64), np.float32))


class _Event:
    """Stands for a CUDA event: ``query`` is True once the copy is done."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def _copying(lease, frame):
    """``frame``'s newest upload, still running: a stand-in for the CUDA
    event ``Lease.upload`` records behind a copy to a card."""
    event = _Event()
    lease._out[id(frame)].event = event
    return event


def test_a_frame_waits_for_its_event_and_the_pool_keeps_its_bound():
    pool = transfer.FramePool(pinned=False)
    lease = pool.lease(2)
    a = lease.take((4, 4))
    event = _copying(lease, a)
    lease.give(a)
    b = lease.take((4, 4))
    assert b is not a  # a's copy has not finished
    assert lease.take((4, 4)) is None  # two frames: the bound
    event.done = True
    assert lease.take((4, 4)) is a
    lease.give(a)
    lease.give(a)  # a second give of one frame is ignored
    assert pool.idle() == 1
    # at the bound an idle frame of another shape makes room; a frame whose
    # copy is still running does not
    c = lease.take((8, 2))
    assert c is not None and pool.frames == 2 and pool.idle() == 0
    _copying(lease, c)
    lease.give(c)
    assert lease.take((3, 3)) is None
    lease.close()
    assert pool.idle() == pool.frames == 2


# two buckets at scale 2: 4 micrographs of (64, 64), 3 of (64, 96) -> (64, 128);
# at batch 2 the second bucket's last batch repeats its last micrograph
SHAPES = [(128, 128)] * 4 + [(128, 192)] * 3


@pytest.fixture
def micrographs(tmp_path):
    rng = np.random.default_rng(19)
    paths = []
    for i, shape in enumerate(SHAPES):
        paths.append(str(tmp_path / f"m{i}.mrc"))
        mrc.write(paths[-1], rng.normal(size=shape).astype(np.float32))
    return paths


def _pipe(**kw):
    return MicrographPipeline(model="resnet8_u32", scale=2, radius=3, threshold=0.0,
                              num_workers=2, device="cpu", **kw)


class _Ledger:
    """Every take, upload and give of a pool frame, in order, by the
    frame's address; and the most frames the pool held."""

    def __init__(self, monkeypatch):
        self.log, self.peak = [], 0
        lock = threading.Lock()
        take, give, upload = (transfer.FramePool._take, transfer.FramePool._give,
                              transfer.Lease.upload)

        def _take(pool, shape):
            block = take(pool, shape)
            with lock:
                if block is not None:
                    self.log.append(("take", block.host.data_ptr()))
                self.peak = max(self.peak, pool.frames)
            return block

        def _give(pool, block):
            with lock:
                self.log.append(("give", block.host.data_ptr()))
            give(pool, block)

        def _upload(lease, r, device):
            if isinstance(r, torch.Tensor):
                with lock:
                    self.log.append(("upload", r.data_ptr()))
            return upload(lease, r, device)

        monkeypatch.setattr(transfer.FramePool, "_take", _take)
        monkeypatch.setattr(transfer.FramePool, "_give", _give)
        monkeypatch.setattr(transfer.Lease, "upload", _upload)

    def states(self, given_unuploaded: bool = False):
        """Each frame's state, "idle", "out" (taken) or "uploaded", after
        checking that no frame is taken while out and that a frame goes
        back after its upload (or, where ``given_unuploaded``, with none)."""
        state = {}
        for op, ptr in list(self.log):
            s = state.get(ptr, "idle")
            if op == "take":
                assert s == "idle", (op, ptr, s)
                state[ptr] = "out"
            elif op == "upload":
                assert s in ("out", "uploaded"), (op, ptr, s)
                state[ptr] = "uploaded"
            else:
                assert s == "uploaded" or (given_unuploaded and s == "out"), (op, ptr, s)
                state[ptr] = "idle"
        return state

    def check(self, pipe, given_unuploaded: bool):
        """``states``, and every frame back in the pool at the end."""
        assert set(self.states(given_unuploaded).values()) == {"idle"}
        assert pipe._frames.idle() == pipe._frames.frames == self.peak


def test_frames_live_until_their_batch_is_uploaded_and_a_second_call_allocates_none(
        micrographs, monkeypatch):
    pipe = _pipe()
    ledger = _Ledger(monkeypatch)
    before = _counts()
    first = []
    for result in pipe.process(micrographs, batch_size=2):
        # a batch's frames, the repeated one too, are back before its answers
        assert "uploaded" not in ledger.states().values()
        first.append(result)
    ledger.check(pipe, given_unuploaded=False)
    mid = _counts()
    assert mid[0] - before[0] == len(micrographs) and mid[1] == before[1]
    second = list(pipe.process(micrographs, batch_size=2))
    ledger.check(pipe, given_unuploaded=False)
    after = _counts()
    assert after[0] - mid[0] == len(micrographs)
    assert after[1:] == mid[1:]  # no fallback, no allocation
    assert [r[0] for r in first] == [r[0] for r in second] == micrographs
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    # the last batch repeats its last frame; it went back once
    gives = [p for op, p in ledger.log if op == "give"]
    takes = [p for op, p in ledger.log if op == "take"]
    assert len(gives) == len(takes) == 2 * len(micrographs)


@pytest.mark.parametrize("batch_size,prefetch", [(1, 0), (1, 1), (2, 2)])
def test_the_pool_stays_within_the_frames_in_flight(tmp_path, monkeypatch, batch_size, prefetch):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(12):
        paths.append(str(tmp_path / f"m{i}.mrc"))
        mrc.write(paths[-1], rng.normal(size=(64, 64)).astype(np.float32))
    pipe = _pipe()
    ledger = _Ledger(monkeypatch)
    fn_for = pipe._fn_for

    def slow(bucket):
        fn = fn_for(bucket)

        def run(*args, **kwargs):
            threading.Event().wait(0.05)  # the loaders run ahead meanwhile
            return fn(*args, **kwargs)
        return run

    pipe._fn_for = slow
    out = list(pipe.process(paths, batch_size=batch_size, prefetch=prefetch))
    assert len(out) == len(paths)
    ledger.check(pipe, given_unuploaded=False)
    assert 2 <= ledger.peak <= transfer.in_flight(batch_size, prefetch)


def test_a_failed_read_under_skip_errors_gives_its_frame_back(micrographs, tmp_path,
                                                              monkeypatch):
    short = tmp_path / "short.mrc"
    short.write_bytes(open(micrographs[0], "rb").read()[:-4096])  # the header is whole
    paths = micrographs[:2] + [str(short)] + micrographs[2:]
    pipe = _pipe(skip_errors=True)
    ledger = _Ledger(monkeypatch)
    with pytest.warns(UserWarning, match="short.mrc.*skipped"):
        got = list(pipe.process(paths, batch_size=2))
    assert [r[0] for r in got] == micrographs
    ledger.check(pipe, given_unuploaded=True)
    with pytest.raises(ValueError, match="ends after"):
        list(_pipe().process(paths, batch_size=2))


@pytest.mark.parametrize("how", ["close", "device_error"])
def test_a_call_that_ends_early_gives_every_frame_back(micrographs, monkeypatch, how):
    pipe = _pipe()
    ledger = _Ledger(monkeypatch)
    if how == "close":
        gen = pipe.process(micrographs, batch_size=2)
        next(gen)
        gen.close()
    else:
        def broken(*args, **kwargs):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        pipe._fn_for = lambda bucket: broken
        with pytest.raises(RuntimeError, match="illegal memory access"):
            list(pipe.process(micrographs, batch_size=2))
    ledger.check(pipe, given_unuploaded=True)
    assert pipe._frames.frames > 0


@pytest.mark.parametrize("denoise", [None, "fcnn"])
def test_pool_frames_and_pageable_arrays_give_the_same_answers(micrographs, monkeypatch,
                                                               denoise):
    pipe = _pipe(denoise_model=denoise)
    pooled = list(pipe.process(micrographs, batch_size=2))
    monkeypatch.setattr(transfer.FramePool, "_take", lambda pool, shape: None)
    before = _counts()
    pageable = list(pipe.process(micrographs, batch_size=2))
    assert _counts()[1] - before[1] == len(micrographs)
    assert [r[0] for r in pooled] == [r[0] for r in pageable]
    for a, b in zip(pooled, pageable):
        assert len(a) == len(b) == (4 if denoise else 3)
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
