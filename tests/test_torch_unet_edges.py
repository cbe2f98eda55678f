"""The U-Net's fused route on the CPU: when ``UDenoiseNet`` takes it, how it
wires the convolutions to the edge passes (``ops/unet_edges``), the shapes
the wrappers plan, and what the wrappers refuse. The kernels themselves run
only on a card (``tests/test_torch_unet_edges_cuda.py``)."""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from topaz_tpu_torch.models import denoise as D
from topaz_tpu_torch.models.denoise_factory import new_denoiser
from topaz_tpu_torch.ops import unet_edges as E


def _params(dtype=torch.float32, requires_grad=True):
    return [torch.zeros(3, 2, 3, 3, dtype=dtype).requires_grad_(requires_grad),
            torch.zeros(3, dtype=dtype).requires_grad_(requires_grad)]


def _input(is_cuda=True, dtype=torch.float32, requires_grad=False):
    return SimpleNamespace(is_cuda=is_cuda, dtype=dtype, requires_grad=requires_grad)


@pytest.mark.parametrize("grad", [False, True])
def test_the_route_fuses_a_float32_card_forward_that_needs_no_graph(grad):
    """Gradients off, or nothing that requires one: the fused route."""
    with torch.set_grad_enabled(grad):
        assert D.fused_route(_input(), _params(requires_grad=not grad))


@pytest.mark.parametrize("case", ["cpu", "bf16 input", "bf16 weights", "training",
                                  "input requires grad", "channels-last weights"])
def test_the_route_keeps_the_modules_otherwise(case):
    x, params, grad = _input(), _params(requires_grad=False), False
    if case == "cpu":
        x = _input(is_cuda=False)
    elif case == "bf16 input":
        x = _input(dtype=torch.bfloat16)
    elif case == "bf16 weights":
        params = _params(torch.bfloat16, requires_grad=False)
    elif case == "training":
        params, grad = _params(requires_grad=True), True
    elif case == "input requires grad":
        x, grad = _input(requires_grad=True), True
    else:
        params[0] = params[0].to(memory_format=torch.channels_last)
    with torch.set_grad_enabled(grad):
        assert not D.fused_route(x, params)


@pytest.mark.parametrize("case", ["cpu", "training", "bf16"])
def test_the_modules_route_is_counted(case):
    net = new_denoiser("unet-small", nf=4, base_width=3, top_width=3)
    x = torch.randn(2, 1, 16, 16)
    before = (D.fused_forwards, D.plain_forwards, E.launches)
    if case == "cpu":
        with torch.no_grad():
            y = net(x)
        assert torch.equal(y, net._plain(x))
    elif case == "training":
        net(x).sum().backward()
    else:
        with torch.no_grad():
            net.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert (D.fused_forwards, D.plain_forwards - before[1], E.launches) == (
        before[0], 1, before[2])


def _plain_edges(monkeypatch):
    """The fused route's edge passes done by their plain versions."""
    monkeypatch.setattr(E, "bias_lrelu_", lambda x, b, leaky=True: E.bias_lrelu_plain(x, b, leaky))
    monkeypatch.setattr(E, "bias_lrelu_pool", E.bias_lrelu_pool_plain)
    monkeypatch.setattr(E, "bias_lrelu_up_cat", E.bias_lrelu_up_cat_plain)


@pytest.mark.parametrize("arch,dims,nf,shape", [
    ("unet", 2, 8, (2, 1, 67, 45)), ("unet-small", 2, 8, (1, 1, 33, 20)),
    ("unet2", 2, 8, (1, 1, 64, 70)), ("unet3", 2, 8, (3, 1, 40, 37)),
    ("unet", 3, 8, (1, 1, 33, 35, 34)), ("unet", 3, 24, (1, 1, 32, 33, 34))])
def test_the_fused_wiring_is_the_modules_forward(monkeypatch, arch, dims, nf, shape):
    """Each convolution without its bias, then its edge: with the edges'
    plain versions on the CPU the fused route is the modules' forward up to
    the CPU convolution's own bias handling. At nf 24 the 3D U-Net's first
    and last layers are ``TapConv3d`` (the first without its bias)."""
    _plain_edges(monkeypatch)
    net = new_denoiser(arch, nf=nf, base_width=7, top_width=3, dims=dims, seed=2)
    assert isinstance(net.enc1[0], D.TapConv3d) == (dims == 3 and nf == 24)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = net._fused(x), net._plain(x)
    assert got.shape == want.shape == x.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


def _convolutions_visited(net, route, x):
    """The names of ``net``'s convolutions in the order ``route`` runs them,
    each seen where it runs its product (``_conv_forward``), with or
    without its bias."""
    seen = []

    def record(name, conv_forward):
        def run(x, weight, bias):
            seen.append(name)
            return conv_forward(x, weight, bias)
        return run

    convs = [(name, m) for name, m in net.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    for name, m in convs:
        m._conv_forward = record(name, m._conv_forward)
    try:
        with torch.no_grad():
            route(x)
    finally:
        for _, m in convs:
            del m._conv_forward
    return seen


@pytest.mark.parametrize("arch,dims,nf,shape", [
    ("unet", 2, 8, (1, 1, 35, 32)), ("unet-small", 2, 8, (1, 1, 33, 20)),
    ("unet2", 2, 8, (1, 1, 64, 70)), ("unet3", 2, 8, (1, 1, 40, 37)),
    ("unet", 3, 8, (1, 1, 33, 35, 34)), ("unet", 3, 24, (1, 1, 32, 33, 34))])
def test_both_routes_run_the_same_convolutions_in_the_same_order(monkeypatch, arch, dims, nf,
                                                                 shape):
    """The fused forward is a second copy of the U-Net's wiring: it runs
    each of the modules' convolutions once, in the modules' order."""
    _plain_edges(monkeypatch)
    net = new_denoiser(arch, nf=nf, base_width=7, top_width=3, dims=dims, seed=2)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    plain = _convolutions_visited(net, net._plain, x)
    assert sorted(plain) == sorted(name for name, m in net.named_modules()
                                   if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)))
    assert _convolutions_visited(net, net._fused, x) == plain


@pytest.mark.parametrize("k", [3, 7])
def test_tap_conv_without_its_bias(k):
    """The one-input ``TapConv3d`` through ``nn.Conv3d.forward``'s hook:
    without the bias its output is the module's less the bias."""
    conv = D.TapConv3d(1, 6, k, padding=k // 2)
    x = torch.randn(2, 1, 9, 7, 5)
    with torch.no_grad():
        raw = D._unbiased(conv, x)
        torch.testing.assert_close(raw + conv.bias.reshape(1, -1, 1, 1, 1), conv(x))
        assert raw.is_contiguous()


@pytest.mark.parametrize("k", [3, 5])
def test_tap_conv_with_one_output_without_its_bias(k):
    """The one-output ``TapConv3d`` (taps and their sum) through the same
    hook: without the bias its output is the module's less the bias."""
    conv = D.TapConv3d(6, 1, k, padding=k // 2)
    x = torch.randn(2, 6, 9, 7, 5)
    with torch.no_grad():
        raw = D._unbiased(conv, x)
        torch.testing.assert_close(raw + conv.bias.reshape(1, -1, 1, 1, 1), conv(x))
        assert raw.shape == (2, 1, 9, 7, 5)


@pytest.mark.parametrize("spatial", [(33, 47), (30, 41), (2, 3), (9, 14, 11), (16, 13, 3)])
def test_the_pool_shape_is_max_pools(spatial):
    x = torch.randn(2, 3, *spatial)
    pool = F.max_pool2d if len(spatial) == 2 else F.max_pool3d
    assert E.pool_shape(x.shape) == tuple(pool(x, 2).shape)
    assert E.pool_shape(x.shape) == tuple(E.bias_lrelu_pool_plain(x, torch.zeros(3)).shape)


@pytest.mark.parametrize("spatial", [(33, 47), (30, 41), (3, 2), (9, 14, 11), (17, 12, 5)])
@pytest.mark.parametrize("c2", [0, 1, 5])
def test_the_up_cat_shape_is_the_modules(spatial, c2):
    """Upsampled to the skip's (odd) size, the skip's channels after the
    map's: the shape of the modules' ``_up_cat`` (``up_nearest`` alone for a
    skipless level)."""
    h = torch.randn(2, 4, *(max(1, s // 2) for s in spatial))
    skip = torch.randn(2, c2, *spatial)
    want = D._up_cat(h, skip) if c2 else D.up_nearest(h, spatial)
    assert E.up_cat_shape(h.shape, c2, spatial) == tuple(want.shape)
    got = E.bias_lrelu_up_cat_plain(h, torch.zeros(4), skip if c2 else None, spatial)
    assert got.shape == want.shape


def _refusing(monkeypatch):
    def no_build():
        raise AssertionError("the wrapper reached the kernel")
    monkeypatch.setattr(E, "_library", no_build)


def _calls(x):
    b = torch.zeros(x.shape[1], dtype=x.dtype)
    return [lambda: E.bias_lrelu_(x, b), lambda: E.bias_lrelu_pool(x, b),
            lambda: E.bias_lrelu_up_cat(x, b, None, tuple(2 * s for s in x.shape[2:]))]


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA"), ("float64", TypeError, "float32"),
    ("bf16", TypeError, "float32"), ("non-contiguous", ValueError, "contiguous")])
def test_the_wrappers_refuse_before_any_launch(monkeypatch, which, case, error, match):
    _refusing(monkeypatch)
    x = torch.randn(2, 3, 8, 10)
    if case in ("float64", "bf16"):
        x = x.to(torch.float64 if case == "float64" else torch.bfloat16)
    elif case == "non-contiguous":
        x = x.transpose(2, 3)
    launches = E.launches
    with pytest.raises(error, match=match):
        _calls(x)[which]()
    assert E.launches == launches

