"""The port's ``predict`` against the JAX package's, on the CPU.

The bundled ``resnet8_u32`` picker scores the same seeded images through
``topaz_tpu.predict.score`` (spec, params, state) and
``topaz_tpu_torch.predict.score`` (the module on the CPU), dense and
strided, in batches that divide the images unevenly. Tolerance 1e-5
relative to the score maps' largest magnitude: float32 convolutions sum in
other orders in XLA and PyTorch."""

import numpy as np
import pytest
import torch

from topaz_tpu import predict as jpredict
from topaz_tpu.models import factory as jfactory
from topaz_tpu_torch import predict as tpredict
from topaz_tpu_torch.models import factory as tfactory
from torch_threads import one_torch_thread  # noqa: F401


def _images(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def test_batches_equal_to_jax():
    images = _images(5, (4, 6), seed=0)
    want = list(jpredict.batches(images, batch_size=2))
    got = list(tpredict.batches(images, batch_size=2))
    assert [b.shape for b in got] == [b.shape for b in want] == [(2, 4, 6), (2, 4, 6), (1, 4, 6)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dense,shape,batch_size", [(True, (40, 48), 2), (False, (71, 71), 3)])
def test_score_within_1e_5_of_jax(dense, shape, batch_size):
    images = _images(3, shape, seed=1)
    spec, params, state = jfactory.load_picker("resnet8_u32")
    want = jpredict.score(spec, params, state, images, batch_size=batch_size, dense=dense)
    model = tfactory.load_picker("resnet8_u32", device="cpu")
    got = tpredict.score(model, images, batch_size=batch_size, dense=dense, device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_score_stream_is_lazy_and_raises_without_cuda(monkeypatch):
    from topaz_tpu_torch.device import DeviceUnavailableError

    model = tfactory.load_picker("resnet8_u32", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream = tpredict.score_stream(model, _images(1, (32, 32), seed=2))
    with pytest.raises(DeviceUnavailableError):
        next(stream)
