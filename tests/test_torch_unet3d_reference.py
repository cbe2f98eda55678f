"""The port's 3D U-Net and ``Denoise3D`` against the benchmark's plain
reference (``benchmark/reference/unet3d.py``: ``torch.nn.functional`` from
the published ``UDenoiseNet3D`` and ``denoise3d`` patch loop), on the CPU,
with weights written the way the benchmark's ``denoise3d`` driver writes
them (seeded, DHWIO ``.npz``). No JAX.

Tolerances, each with its reason:

* The forward on one input, with gradients on and off: 1e-4 x the output's
  std. The first and last layers run as ``TapConv3d`` taps, which sum in
  another order (each within ~1e-6 of the convolution's largest output,
  ``TapConv3d`` against ``F.conv3d`` at 2e-6); the network turns that change
  of its first layer's output into up to ~1e-5 of its output's std
  (measured 9.9e-6). Grad mode changes no operation: the two forwards are
  equal.
* ``TapConv3d``'s gradients against ``F.conv3d``'s: 1e-5 of each
  gradient's largest magnitude. The taps' backward sums the same products
  in another order, over every output voxel for the weights (measured
  below 2e-6 here; 2e-5 at 10 x 96^3 on an H100).
* ``Denoise3D`` against the patch loop: 1e-4 x the output's std. The port
  takes the volume's and each patch's statistics in float32, the reference
  in float64, so each patch enters the network moved by ~1e-7 of its size;
  the seeded network (He-scaled, so its activations keep their size as a
  trained one's do) turns a relative input change of 1e-7 into up to ~1e-5
  of its output's std at its worst voxel (6.7e-6 at nf 8, 1.1e-5 at nf
  48). Measured in these cases: 6.8e-6 to 9.8e-6.
* Operation counts: equal (integer arithmetic on shapes).
"""

import os
import sys

import numpy as np
import pytest
import torch

from topaz_tpu_torch.denoise import Denoise3D
from topaz_tpu_torch.models.denoise import TapConv3d, arch_layout
from topaz_tpu_torch.models.denoise_factory import load_denoiser
from torch_threads import one_torch_thread  # noqa: F401

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH_DIR not in sys.path:
    sys.path.append(BENCH_DIR)

from harness import spec  # noqa: E402
from reference import counts3d, unet3d  # noqa: E402

PUBLISHED = (48, 7, 3)  # nf, base_width, top_width of unet-3d-10a


def _model(nf, base_width=7, top_width=3):
    return {"arch": "unet", "dims": 3, "nf": nf, "base_width": base_width,
            "top_width": top_width, "levels": 5,
            "layers": unet3d.layers(nf, base_width, top_width)}


def _weights(tmp_path, nf, seed=20, base_width=7):
    path = str(tmp_path / f"unet3d_{nf}.npz")
    spec.driver("denoise3d").write_weights(path, _model(nf, base_width), seed)
    return path


def _volume(shape, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.5, 2.0, size=shape) + rng.normal(size=shape[-1])).astype(np.float32)


@pytest.mark.parametrize("grad", [True, False])
def test_unet3d_forward_matches_reference_at_published_widths(tmp_path, grad):
    path = _weights(tmp_path, PUBLISHED[0])
    net = load_denoiser(path, device="cpu")
    assert isinstance(net.enc1[0], TapConv3d) and isinstance(net.dec1[4], TapConv3d)
    x = torch.from_numpy(_volume((34, 40, 36)))[None, None]
    with torch.set_grad_enabled(grad):
        got = net(x)
    assert got.requires_grad is grad
    got = got.detach()
    with torch.no_grad():
        want = unet3d.unet3d(x, unet3d.load_npz(path, "cpu"))
        assert torch.equal(net(x), got)
    assert got.shape == want.shape == x.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.std())


@pytest.mark.parametrize("cin, cout, k, shape", [
    (1, 48, 7, (2, 1, 13, 17, 11)),   # the first layer, a batch of two, odd sizes
    (1, 6, 3, (1, 1, 5, 6, 7)),
    (32, 1, 3, (2, 32, 9, 10, 12)),   # the last layer
    (5, 1, 5, (1, 5, 7, 8, 6)),
])
def test_tap_conv3d_matches_conv3d(cin, cout, k, shape):
    """``TapConv3d`` is the SAME convolution summed in another order (within
    2e-6 of the largest output), and so is its backward: the gradients of
    its weight, bias and input are ``F.conv3d``'s within 1e-5 of each
    gradient's largest magnitude."""
    gen = torch.Generator().manual_seed(cin * 100 + k)
    conv = TapConv3d(cin, cout, k, padding=k // 2)
    x = torch.randn(shape, generator=gen, requires_grad=True)
    gy = torch.randn((shape[0], cout) + shape[2:], generator=gen)
    want = torch.nn.functional.conv3d(x, conv.weight, conv.bias, padding=k // 2)
    want_grads = torch.autograd.grad(want, (conv.weight, conv.bias, x), gy)
    want = want.detach()
    with torch.no_grad():
        got = conv(x)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
    got_grads = torch.autograd.grad(conv(x), (conv.weight, conv.bias, x), gy)
    for g, w in zip(got_grads, want_grads):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("cin, cout, k, padding", [(2, 3, 3, 1), (1, 4, 5, 0), (4, 1, 3, 2)])
def test_tap_conv3d_refuses_what_its_taps_do_not_compute(cin, cout, k, padding):
    """Taps compute a SAME convolution with one input or one output
    channel; any other convolution is refused, not computed wrongly."""
    with pytest.raises(ValueError, match="one input or output channel"):
        TapConv3d(cin, cout, k, padding=padding)


@pytest.mark.parametrize("nf, shape, kw, route", [
    (8, (20, 40, 36), dict(device_resident=True), "resident"),
    (8, (20, 40, 36), dict(device_resident=False), "streaming"),
    (8, (20, 40, 36), dict(device_resident=False, batch_size=4), "streaming"),
    (PUBLISHED[0], (16, 16, 24), dict(), "resident"),
])
def test_denoise3d_matches_reference_patch_loop(tmp_path, nf, shape, kw, route):
    path = _weights(tmp_path, nf)
    vol = _volume(shape)
    model = Denoise3D(path, device="cpu")
    got = model.denoise(vol, patch_size=16, padding=8, verbose=False, **kw)
    assert model.last_route == route
    want = unet3d.denoise_patches(torch.from_numpy(vol), unet3d.load_npz(path, "cpu"), 16, 8)
    assert got.dtype == np.float32 and got.shape == vol.shape
    assert float(np.abs(got - want.numpy()).max()) <= 1e-4 * float(want.std())


def test_driver_checkpoint_loads_in_the_port(tmp_path):
    """The driver's checkpoint is the program's 3D unet at base width 7, its
    kernels the file's DHWIO arrays turned to OIDHW; the configuration's
    layer list is the port's layout of that model."""
    path = _weights(tmp_path, PUBLISHED[0])
    net = load_denoiser(path, device="cpu")
    assert net.meta == {"arch": "unet", "dims": 3, "nf": 48, "base_width": 7, "top_width": 3}
    assert isinstance(net.enc1[0], torch.nn.Conv3d) and net.enc1[0].kernel_size == (7, 7, 7)
    with np.load(path) as z:
        for layer in unet3d.layers(*PUBLISHED):
            mod, idx = layer["name"].split(".")
            conv = getattr(net, mod)[int(idx)]
            np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                          z[f"params:{layer['name']}.w"].transpose(4, 3, 0, 1, 2))
            np.testing.assert_array_equal(conv.bias.detach().numpy(),
                                          z[f"params:{layer['name']}.b"])
    cfg = spec.Cell(spec.load(), "denoise3d.tomo").config["denoiser3d"]
    assert cfg["layers"] == unet3d.layers(cfg["nf"], cfg["base_width"], cfg["top_width"],
                                          cfg["levels"])
    layout = arch_layout("unet", *PUBLISHED)
    assert {f"{m}.{i}": v for m, convs in layout.items() for i, v in convs.items()} == \
        {layer["name"]: (layer["k"], layer["cin"], layer["cout"]) for layer in cfg["layers"]}


def test_counts3d_against_the_reference_convolutions(monkeypatch):
    """The count from the layer list equals the operations of every
    convolution the reference runs on a 192^3 patch (shapes only, on the
    meta device)."""
    real = unet3d.F.conv3d
    ops = []

    def counting(x, w, b=None, **kw):
        y = real(x, w, b, **kw)
        ops.append(2 * w[0].numel() * y.numel())  # cin k^3 multiply-adds an output
        return y

    monkeypatch.setattr(unet3d.F, "conv3d", counting)
    layers = unet3d.layers(*PUBLISHED)
    w = {}
    for layer in layers:
        k, cin, cout = layer["k"], layer["cin"], layer["cout"]
        w[layer["name"] + ".w"] = torch.empty((cout, cin, k, k, k), device="meta")
        w[layer["name"] + ".b"] = torch.empty((cout,), device="meta")
    d = 192
    out = unet3d.unet3d(torch.empty((1, 1, d, d, d), device="meta"), w)
    assert out.shape == (1, 1, d, d, d) and len(ops) == len(layers)
    assert sum(ops) == counts3d.unet3d_flops_per_voxel(layers) * d ** 3
    assert counts3d.unet3d_flops_per_voxel(layers) == pytest.approx(675_886.171875)
    # the cell's tomogram: 2 x 6 x 8 patches of 192^3
    assert counts3d.patch_grid((192, 512, 720), 96, 48) == (96, 96 * d ** 3)
    assert counts3d.tomogram_flops((192, 512, 720), layers, 96, 48) == \
        96 * d ** 3 * counts3d.unet3d_flops_per_voxel(layers)
