"""The U-Net's edge kernels (``csrc/unet_edges.cu``) on the card against
their plain compositions, and the U-Net's fused forward against its
modules' forward: bit-equal, since each kernel does the same float
operations in the same order.

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_unet_edges_cuda.py``. Without a card it skips."""

import pytest
import torch

from topaz_tpu_torch.device import resolve_device
from topaz_tpu_torch.models import denoise as D
from topaz_tpu_torch.models.denoise_factory import new_denoiser
from topaz_tpu_torch.ops import unet_edges as E


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the U-Net's edge kernels")
    device = resolve_device("cuda")  # the exact profile: TF32 off
    assert torch.backends.cudnn.allow_tf32 is False
    return device


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, NaN at the same places and every other value equal bit
    for bit (so -0.0 is not 0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def edge_input(shape, device, seed=0, specials=True):
    """Normal values with exact zeros of both signs, and, with
    ``specials``, +-inf and NaN sprinkled in."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    u = torch.rand(shape, generator=g)
    x[u < 0.02] = 0.0
    x[(u >= 0.02) & (u < 0.04)] = -0.0
    if specials:
        x[(u >= 0.04) & (u < 0.045)] = float("inf")
        x[(u >= 0.045) & (u < 0.05)] = float("-inf")
        x[(u >= 0.05) & (u < 0.055)] = float("nan")
    return x.to(device)


def edge_bias(c, device, seed=1):
    b = torch.randn(c, generator=torch.Generator().manual_seed(seed))
    b[0] = -0.0
    return b.to(device)


SPATIAL = [(64, 96), (33, 47), (30, 41), (16, 12, 20), (9, 14, 11)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("spatial", SPATIAL)
@pytest.mark.parametrize("leaky", [True, False])
def test_bias_lrelu_kernel_is_its_plain_version(cuda_device, n, spatial, leaky):
    x = edge_input((n, 5, *spatial), cuda_device)
    b = edge_bias(5, cuda_device)
    want = E.bias_lrelu_plain(x, b, leaky)
    got = E.bias_lrelu_(x.clone(), b, leaky)
    torch.cuda.synchronize()
    assert same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("spatial", SPATIAL)
def test_bias_lrelu_pool_kernel_is_its_plain_version(cuda_device, n, spatial):
    x = edge_input((n, 6, *spatial), cuda_device)
    b = edge_bias(6, cuda_device)
    got = E.bias_lrelu_pool(x, b)
    torch.cuda.synchronize()
    assert got.shape == E.pool_shape(x.shape)
    assert same_bits(got, E.bias_lrelu_pool_plain(x, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("c2", [0, 1, 48])
@pytest.mark.parametrize("spatial", SPATIAL)
def test_bias_lrelu_up_cat_kernel_is_its_plain_version(cuda_device, n, c2, spatial):
    """The low-resolution map is the pooled size of the target, as in the
    U-Net: the integer nearest rule maps odd targets unevenly."""
    h = edge_input((n, 7, *(s // 2 for s in spatial)), cuda_device)
    b = edge_bias(7, cuda_device)
    skip = edge_input((n, c2, *spatial), cuda_device, seed=2) if c2 else None
    got = E.bias_lrelu_up_cat(h, b, skip, spatial)
    torch.cuda.synchronize()
    assert got.shape == E.up_cat_shape(h.shape, c2, spatial)
    assert same_bits(got, E.bias_lrelu_up_cat_plain(h, b, skip, spatial))


@pytest.mark.cuda
def test_kernels_take_a_misaligned_view_on_the_scalar_route(cuda_device):
    """A contiguous map that starts 4 bytes into its storage cannot take
    128-bit loads; the kernels fall back to one float a thread."""
    base = edge_input((1 + 2 * 3 * 32 * 32,), cuda_device)
    x = base[1:1 + 2 * 4 * 16 * 16].view(2, 4, 16, 16)
    b = edge_bias(4, cuda_device)
    assert same_bits(E.bias_lrelu_pool(x, b), E.bias_lrelu_pool_plain(x, b))
    skip = base[1:2 * 3 * 32 * 32 + 1].view(2, 3, 32, 32)
    assert same_bits(E.bias_lrelu_up_cat(x, b, skip, (32, 32)),
                     E.bias_lrelu_up_cat_plain(x, b, skip, (32, 32)))
    want = E.bias_lrelu_plain(x, b)
    assert same_bits(E.bias_lrelu_(x, b), want)


@pytest.mark.cuda
def test_kernel_errors_are_raised(cuda_device):
    x = torch.zeros(1, 2, 4, 4, device=cuda_device)
    with pytest.raises(ValueError, match="bias"):
        E.bias_lrelu_(x, torch.zeros(3, device=cuda_device))
    with pytest.raises(ValueError, match="pools to"):
        E.bias_lrelu_pool(torch.zeros(1, 2, 1, 4, device=cuda_device),
                          torch.zeros(2, device=cuda_device))
    with pytest.raises(ValueError, match="skip"):
        E.bias_lrelu_up_cat(x, torch.zeros(2, device=cuda_device),
                            torch.zeros(1, 1, 8, 9, device=cuda_device), (8, 8))


ARCHS_2D = [("unet", (1, 1, 256, 256)), ("unet", (8, 1, 96, 128)), ("unet", (2, 1, 203, 317)),
            ("unet-small", (3, 1, 77, 130)), ("unet2", (2, 1, 160, 99)),
            ("unet3", (1, 1, 128, 192))]


def fused_and_plain(net, x):
    """The forward through ``__call__`` with gradients off (the fused route,
    counted) and the modules' forward."""
    before = (D.fused_forwards, D.plain_forwards)
    with torch.no_grad():
        got = net(x)
        want = net._plain(x)
    torch.cuda.synchronize()
    assert (D.fused_forwards - before[0], D.plain_forwards - before[1]) == (1, 0)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape", ARCHS_2D)
def test_unet_fused_forward_is_the_modules_forward_2d(cuda_device, arch, shape):
    """The published widths (nf 48, the bundled unet's 7 and 3)."""
    net = new_denoiser(arch, nf=48, base_width=7, top_width=3, seed=5).to(cuda_device)
    x = edge_input(shape, cuda_device, seed=3, specials=False)
    launches = E.launches
    got, want = fused_and_plain(net, x)
    assert E.launches - launches == 3 * net.levels + 2
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,base_width", [((1, 1, 64, 64, 64), 7), ((2, 1, 35, 38, 41), 7),
                                              ((1, 1, 40, 32, 48), 11)])
def test_unet_fused_forward_is_the_modules_forward_3d(cuda_device, shape, base_width):
    """unet-3d at nf 48: with base 7 the first and last layers are
    ``TapConv3d`` (the first hands its bias to the pool pass); with base 11
    the first is cuDNN's."""
    net = new_denoiser("unet", nf=48, base_width=base_width, top_width=3, dims=3,
                       seed=6).to(cuda_device)
    assert isinstance(net.enc1[0], D.TapConv3d) == (base_width == 7)
    x = edge_input(shape, cuda_device, seed=4, specials=False)
    got, want = fused_and_plain(net, x)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_training_and_bf16_keep_the_modules(cuda_device):
    net = new_denoiser("unet-small", nf=8, base_width=7, top_width=3).to(cuda_device)
    x = edge_input((2, 1, 32, 32), cuda_device, specials=False)
    before = (D.fused_forwards, D.plain_forwards, E.launches)
    net(x).sum().backward()
    with torch.no_grad():
        net.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert (D.fused_forwards, D.plain_forwards, E.launches) == (
        before[0], before[1] + 2, before[2])
