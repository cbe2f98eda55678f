"""The batched pipeline on the card against the same pipeline on the CPU,
and ``fetch_async``'s copies out of the card.

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_pipeline_cuda.py``. Without a card it skips. Picks may
differ only at near-ties: the card and the CPU sum float32 in other orders,
and an EM lane of the GMM fit may then stop one step apart, which moves a
score s by ~1e-4 |s|. So a pick of one run that the other lacks must lie
within 1e-3 max(1, |s|) of a deciding score (the threshold, or a pick of
the other run inside the radius), matched scores agree to the same, and
denoised pixels to 1e-3 x std."""

import numpy as np
import pytest
import torch

from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.pipeline import MicrographPipeline
from topaz_tpu_torch.utils.batching import fetch_async

RADIUS, THRESHOLD = 6, 1.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the pipeline and the disk-max kernel on the card")
    return torch.device("cuda")


def _diff(a, b):
    return abs(a - b) / max(1.0, abs(a))


def _near_tie_compare(card, cpu):
    for mine, other in ((card, cpu), (cpu, card)):
        for p in set(mine) - set(other):
            gaps = [_diff(mine[p], THRESHOLD)] + [
                _diff(mine[p], other[q]) for q in other
                if (q[0] - p[0]) ** 2 + (q[1] - p[1]) ** 2 <= RADIUS ** 2]
            assert min(gaps) <= 1e-3, (p, mine[p], gaps)
    common = set(card) & set(cpu)
    assert common
    return max(_diff(card[p], cpu[p]) for p in common)


@pytest.mark.cuda
def test_two_bucket_pipeline_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(200, 256), (256, 250), (330, 256), (360, 250)]):
        x = rng.normal(0, 1, (h, w)).astype(np.float32)
        yy, xx = np.mgrid[0:h, 0:w]
        for cy, cx in rng.integers(20, min(h, w) - 20, size=(6, 2)):
            x -= 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0).astype(np.float32)
        paths.append(str(tmp_path / f"m{i}.mrc"))
        mrc.write(paths[-1], x)
    kw = dict(model="resnet8_u32", denoise_model="fcnn", scale=1, radius=RADIUS,
              threshold=THRESHOLD, bucket_step=64, num_workers=2)
    card = MicrographPipeline(device=cuda_device, **kw)
    cpu = MicrographPipeline(device="cpu", **kw)
    got = list(card.process(paths, batch_size=2))
    want = list(cpu.process(paths, batch_size=2))
    assert card.num_programs == cpu.num_programs == {"main": 2, "prep": 0}
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        err = _near_tie_compare({tuple(c): s for s, c in zip(g[1], g[2])},
                                {tuple(c): s for s, c in zip(w[1], w[2])})
        assert err <= 1e-3
        np.testing.assert_allclose(g[3], w[3], atol=1e-3 * w[3].std(), rtol=0)


@pytest.mark.cuda
def test_fetch_async_returns_the_right_bytes(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for _ in range(3):
        # long enough that the copies start before the producing kernels end
        a = torch.randn((4096, 4096), device=cuda_device, generator=g)
        b = torch.randint(-9, 9, (8, 600, 2), device=cuda_device, generator=g, dtype=torch.int32)
        a = a @ a  # still queued on the stream when the copy is issued
        c = a.sum(dim=0) > 0
        got = fetch_async(a, None, b, c, np.arange(3))
        assert got[1] is None
        np.testing.assert_array_equal(got[0], a.cpu().numpy())
        np.testing.assert_array_equal(got[2], b.cpu().numpy())
        np.testing.assert_array_equal(got[3], c.cpu().numpy())
        np.testing.assert_array_equal(got[4], np.arange(3))
