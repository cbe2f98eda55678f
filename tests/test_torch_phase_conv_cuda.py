"""The phase route of the 3D picker's dilated convolutions on the card:
``layers.phase_conv3d`` at the shapes of one 96^3 tile's 166^3 window of
the 3D resnet8 at units 32, against ``F.conv3d`` at the same dilation, and
``extract.pick_volume`` with the route on against the direct route.

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_phase_conv_cuda.py``. Without a card it skips."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from topaz_tpu_torch import extract
from topaz_tpu_torch.device import resolve_device
from topaz_tpu_torch.models import layers as L
from topaz_tpu_torch.models.factory import new_picker
from topaz_tpu_torch.models.tiling import classify_patches_3d


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the phase route engages on a card")
    device = resolve_device("cuda")  # the exact profile: TF32 off
    assert torch.backends.cudnn.allow_tf32 is False
    return device


# (cin, cout, kernel, dilation, input size) of the dense form's dilated
# convolutions on a 166^3 window: ResidA conv0/conv1 at 2/4, 2/4 and 4/8,
# then the 5^3 at 4
TILE_CONVS = [(32, 32, 3, 2, 160), (32, 32, 3, 4, 156), (32, 32, 3, 2, 148),
              (32, 64, 3, 4, 144), (64, 64, 3, 4, 136), (64, 64, 3, 8, 128),
              (64, 128, 5, 4, 112)]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k,d,n", TILE_CONVS)
def test_phase_conv_is_the_dilated_conv_at_the_tile_shapes(cuda_device, cin, cout, k, d, n):
    g = torch.Generator(device=cuda_device).manual_seed(cin + cout + k + d)
    x = torch.randn((1, cin, n, n, n), device=cuda_device, generator=g)
    w = torch.randn((cout, cin, k, k, k), device=cuda_device, generator=g) / (cin * k ** 3) ** 0.5
    b = torch.randn(cout, device=cuda_device, generator=g)
    with torch.inference_mode():
        want = F.conv3d(x, w, b, dilation=d)
        got = L.phase_conv3d(x, w, b, d)
        assert L.phase_route(x, w, b, 1, d) == (cout >= 64)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_pick_volume_on_the_phase_route_is_the_direct_route(cuda_device, monkeypatch):
    """A seeded 64 x 128 x 160 tomogram in 4 tiles, picked above its score
    map's 0.999 quantile: the same picks, scores within 1e-5; each tile
    runs its four 64-channel dilated convolutions on the route and its
    three 32-channel ones direct. The kernels are scaled from the default
    draw to He's (variance 2 / fan-in), as a trained picker's keep the
    activations' size: with the default's the map is the head's bias give
    or take ~1e-6, and rounding reorders its near-ties."""
    model = new_picker("resnet8", units=32, bn=True, dims=3, seed=7, device=cuda_device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_w"):
                p.mul_(6 ** 0.5)
    vol = np.random.default_rng(8).normal(size=(64, 128, 160)).astype(np.float32)
    before = (L.phase_convs, L.direct_dilated_convs)
    score = classify_patches_3d(model, vol).reshape(-1)
    threshold = float(torch.kthvalue(score, int(0.999 * score.numel())).values)
    scores, coords = extract.pick_volume(model, vol, 8, threshold)
    assert (L.phase_convs - before[0], L.direct_dilated_convs - before[1]) == (8 * 4, 6 * 4)
    monkeypatch.setattr(L, "phase_route", lambda *a: False)
    before = (L.phase_convs, L.direct_dilated_convs)
    want_scores, want_coords = extract.pick_volume(model, vol, 8, threshold)
    assert (L.phase_convs - before[0], L.direct_dilated_convs - before[1]) == (0, 7 * 4)
    assert len(scores) > 0
    np.testing.assert_array_equal(coords, want_coords)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-5 * float(
        np.abs(want_scores).max()))


@pytest.mark.cuda
def test_training_keeps_the_direct_route(cuda_device):
    """A dense forward that builds a graph runs no phase convolution."""
    model = new_picker("resnet8", units=32, dims=3, seed=9, device=cuda_device)
    x = torch.randn((1, 80, 80, 80), device=cuda_device)
    before = (L.phase_convs, L.direct_dilated_convs)
    model(x, pad=False).sum().backward()
    assert (L.phase_convs, L.direct_dilated_convs - before[1]) == (before[0], 7)
