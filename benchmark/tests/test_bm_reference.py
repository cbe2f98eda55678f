"""The plain reference on tiny inputs: shapes, control flow, and the pick
check's conditions."""

import math

import numpy as np
import pytest
import torch

from harness import check
from reference import model, nms, prep

PIS = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.98, 1.0]


def test_bm_fourier_crop_keeps_low_frequencies():
    x = torch.randn(40, 56, generator=torch.Generator().manual_seed(0))
    y = prep.fourier_crop(x, 4)
    assert y.shape == (10, 14) and y.dtype == torch.float32
    # the mean survives the crop and its energy rescale
    assert float(y.mean()) == pytest.approx(float(x.mean()), abs=1e-6)
    # a band-limited image is only resampled
    yy, xx = torch.meshgrid(torch.arange(40.), torch.arange(56.), indexing="ij")
    low = torch.cos(2 * math.pi * yy / 40) + torch.sin(2 * math.pi * 2 * xx / 56)
    ys, xs = torch.meshgrid(torch.arange(10.) * 4, torch.arange(14.) * 4, indexing="ij")
    want = torch.cos(2 * math.pi * ys / 40) + torch.sin(2 * math.pi * 2 * xs / 56)
    assert torch.allclose(prep.fourier_crop(low, 4), want, atol=1e-5)


def test_bm_gmm_fit_finds_the_bright_component():
    g = torch.Generator().manual_seed(1)
    x = torch.cat([torch.randn(2, 3000, generator=g) * 0.3,
                   torch.randn(2, 1000, generator=g) * 0.3 + 1.5], dim=1)
    # a flat prior: the two-component fit wins, and its bright component
    # normalizes
    mu, std, steps, admitted = prep.norm_fit(x, PIS, 1.0, 1.0, 1e-3, 100)
    assert steps.shape == (2, 11)
    assert torch.all(steps >= 1) and torch.all(steps <= 100)
    assert torch.allclose(mu, torch.full((2,), 1.5), atol=0.1)
    assert torch.allclose(std, torch.full((2,), 0.3), atol=0.05)
    for b in range(2):
        # the chosen fit comes first among the admitted ones
        assert float(admitted[b][0][0]) == float(mu[b])
        assert float(admitted[b][1][0]) == float(std[b])
    # Topaz's prior Beta(900, 1) pulls pi to 1: on 4000 pixels the
    # single-component model (mean, unbiased std) wins
    mu, std, _, _ = prep.norm_fit(x, PIS, 900.0, 1.0, 1e-3, 100)
    assert torch.allclose(mu, x.mean(-1), atol=1e-6)
    assert torch.allclose(std, x.std(-1), atol=1e-5)


def test_bm_stops_reads_the_early_exit():
    logp = torch.tensor([[0.0, 0.0], [1.0, 0.5], [1.5, 0.5005], [1.5004, 0.6], [2.0, 0.7]])
    # lane 0 stops at step 3 (gain 4e-4), lane 1 at step 2 (gain 5e-4)
    assert prep.stops(logp, 1e-3).tolist() == [3, 2]
    assert prep.stops(torch.arange(5.)[:, None], 1e-3).tolist() == [4]


def _greedy_by_hand(S, r, t):
    H, W = S.shape
    order = np.argsort(S.ravel(), kind="stable")[::-1]
    free = np.ones((H, W), bool)
    picks = []
    yy, xx = np.mgrid[:H, :W]
    for i in order:
        y, x = divmod(int(i), W)
        if S[y, x] <= t:
            break
        if free[y, x]:
            picks.append((y, x))
            free &= (yy - y) ** 2 + (xx - x) ** 2 > r * r
    return sorted(picks)


def test_bm_disk_max_and_greedy_nms_by_hand():
    g = torch.Generator().manual_seed(2)
    S = torch.randn(1, 23, 31, generator=g, dtype=torch.float64)
    r = 3
    out = nms.disk_max(S, r)
    H, W = S.shape[1:]
    for y, x in [(0, 0), (5, 7), (22, 30), (11, 0)]:
        vals = [float(S[0, yy, xx]) for yy in range(H) for xx in range(W)
                if (yy - y) ** 2 + (xx - x) ** 2 <= r * r]
        assert float(out[0, y, x]) == max(vals)
    taken = nms.greedy_nms(S, r, 0.5)[0]
    got = sorted(map(tuple, torch.nonzero(taken).tolist()))
    assert got == _greedy_by_hand(S[0].numpy(), r, 0.5)


def test_bm_pick_gap_reads_each_condition():
    g = torch.Generator().manual_seed(3)
    S = torch.randn(30, 40, generator=g)
    r, t = 4, 0.0
    taken = nms.greedy_nms(S[None], r, t)[0]
    ys, xs = torch.nonzero(taken, as_tuple=True)
    scores, coords = S[ys, xs].numpy(), torch.stack([xs, ys], 1).numpy()
    assert check.pick_gap(S, scores, coords, r, t) == 0.0
    # a wrong score, a missing pick, two picks too close, a pick off the image
    assert check.pick_gap(S, scores + 0.01, coords, r, t) == pytest.approx(
        float((0.01 / torch.clamp(S[ys, xs].abs(), min=1)).max()), rel=1e-4)
    assert check.pick_gap(S, scores[1:], coords[1:], r, t) > 0.0
    close = np.concatenate([coords, coords[:1] + [1, 0]])
    assert check.pick_gap(S, np.append(scores, scores[0]), close, r, t) == check.FAULT
    assert check.pick_gap(S, scores[:1], np.array([[40, 0]]), r, t) == check.FAULT
    # the closest admitted map is the one judged
    maps = torch.stack([S + 0.5, S, S - 0.5])
    assert check.answer_gap(maps, scores, coords, r, t) == 0.0


def test_bm_models_keep_shapes():
    layers = [{"op": "conv", "k": 3, "cin": 1, "cout": 4, "stride": 2, "dilation": 1},
              {"op": "resid", "cin": 4, "hidden": 4, "cout": 8, "stride": 1, "dilation": 2},
              {"op": "conv", "k": 3, "cin": 8, "cout": 8, "stride": 1, "dilation": 1}]
    g = torch.Generator().manual_seed(4)
    w = {"features.0.conv_w": torch.randn(4, 1, 3, 3, generator=g), "features.0.conv_b": torch.zeros(4),
         "features.1.conv0_w": torch.randn(4, 4, 3, 3, generator=g), "features.1.conv0_b": torch.zeros(4),
         "features.1.conv1_w": torch.randn(8, 4, 3, 3, generator=g), "features.1.conv1_b": torch.zeros(8),
         "features.1.proj_w": torch.randn(8, 4, 1, 1, generator=g),
         "features.2.conv_w": torch.randn(8, 8, 3, 3, generator=g), "features.2.conv_b": torch.zeros(8),
         "classifier.w": torch.randn(1, 8, 1, 1, generator=g), "classifier.b": torch.zeros(1)}
    assert model.receptive_field(layers) == 19
    assert model.picker_scores(torch.randn(2, 17, 21), layers, w).shape == (2, 17, 21)
    nf = 2
    u = {}
    shapes = {"enc1.0": (nf, 1, 3), "enc2.0": (nf, nf, 3), "dec2.0": (2 * nf, 2 * nf, 3),
              "dec2.2": (2 * nf, 2 * nf, 3), "dec1.0": (4, 2 * nf + 1, 3),
              "dec1.2": (3, 4, 3), "dec1.4": (1, 3, 3)}
    for name, (o, i, k) in shapes.items():
        u[name + ".w"], u[name + ".b"] = torch.randn(o, i, k, k, generator=g), torch.zeros(o)
    u["enc3.0.w"], u["enc3.0.b"] = torch.randn(nf, nf, 3, 3, generator=g), torch.zeros(nf)
    assert model.unet(torch.randn(1, 1, 20, 28), u, levels=2).shape == (1, 1, 20, 28)
