"""The phase route of the pickers' dilated 3D convolutions on the CPU:
``layers.phase_conv3d`` against ``F.conv3d`` at the same dilation, when
``conv_nd`` takes the route and what it counts, and the 3D dense picker
with the route forced on against the direct route and the JAX picker. On
a card the route engages by itself (``tests/test_torch_phase_conv_cuda.py``)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from topaz_tpu.models import factory as jfactory
from topaz_tpu.models.picker import apply_picker
from topaz_tpu_torch.models import factory as tfactory
from topaz_tpu_torch.models import layers as L
from topaz_tpu_torch.models.picker import make_picker_spec
from torch_threads import one_torch_thread  # noqa: F401


def _sizes(d, k, kind):
    """Spatial sizes with a VALID output: each a multiple of d (``whole``),
    none a multiple (``ragged``), or one axis one short of a multiple, so
    that its last phase is one row shorter than the others (``short``)."""
    base = d * (k - 1) + 1
    if kind == "whole":
        return (-(-base // d) * d, -(-base // d) * d + d, -(-base // d) * d)
    if kind == "ragged":
        return tuple(n if n % d else n + 1 for n in (base, base + 2, base + d + 1))
    return (-(-base // d) * d + d - 1, -(-base // d) * d, -(-base // d) * d)


CASES = [(1, 1, 4, True), (2, 32, 32, False), (1, 32, 1, True), (2, 1, 32, False)]


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("kind", ["whole", "ragged", "short"])
@pytest.mark.parametrize("n,cin,cout,bias", CASES)
def test_phase_conv_is_the_dilated_conv(d, k, kind, n, cin, cout, bias):
    g = torch.Generator().manual_seed(d * 100 + k * 10 + cin + cout)
    x = torch.randn((n, cin) + _sizes(d, k, kind), generator=g)
    w = torch.randn((cout, cin, k, k, k), generator=g)
    b = torch.randn(cout, generator=g) if bias else None
    want = F.conv3d(x, w, b, dilation=d)
    got = L.phase_conv3d(x, w, b, d)
    assert got.shape == want.shape and got.is_contiguous()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_phase_conv_takes_a_strided_view():
    """An input that is a crop of a larger map, as a skip path's."""
    g = torch.Generator().manual_seed(1)
    big = torch.randn(2, 3, 20, 21, 22, generator=g)
    x = big[:, :, 1:-2, 2:, :-3]
    w = torch.randn(4, 3, 3, 3, 3, generator=g)
    torch.testing.assert_close(L.phase_conv3d(x, w, None, 4), F.conv3d(x, w, dilation=4),
                               rtol=1e-5, atol=1e-5)


def _fake(dim=5, is_cuda=True, dtype=torch.float32, requires_grad=False):
    return SimpleNamespace(dim=lambda: dim, is_cuda=is_cuda, dtype=dtype,
                           requires_grad=requires_grad)


def _weights(requires_grad=False, dtype=torch.float32, cout=64):
    return (torch.zeros(cout, 2, 3, 3, 3, dtype=dtype).requires_grad_(requires_grad),
            torch.zeros(cout, dtype=dtype).requires_grad_(requires_grad))


@pytest.mark.parametrize("grad", [False, True])
def test_the_phase_route_takes_a_float32_card_conv_that_needs_no_graph(grad):
    """Gradients off, or nothing that requires one."""
    w, b = _weights(requires_grad=not grad)
    with torch.set_grad_enabled(grad):
        assert L.phase_route(_fake(), w, b, 1, 2)
        assert L.phase_route(_fake(), w, None, 1, 8)


@pytest.mark.parametrize("case", ["cpu", "training", "input requires grad", "2d", "dilation 1",
                                  "stride 2", "float64 input", "bf16 weights",
                                  "32 output channels"])
def test_the_phase_route_keeps_the_direct_conv_otherwise(case):
    x, (w, b), grad, stride, dilation = _fake(), _weights(), False, 1, 2
    if case == "cpu":
        x = _fake(is_cuda=False)
    elif case == "training":
        (w, b), grad = _weights(requires_grad=True), True
    elif case == "input requires grad":
        x, grad = _fake(requires_grad=True), True
    elif case == "2d":
        x = _fake(dim=4)
    elif case == "dilation 1":
        dilation = 1
    elif case == "stride 2":
        stride = 2
    elif case == "float64 input":
        x = _fake(dtype=torch.float64)
    elif case == "32 output channels":
        w, b = _weights(cout=32)
    else:
        w, b = _weights(dtype=torch.bfloat16)
    with torch.set_grad_enabled(grad):
        assert not L.phase_route(x, w, b, stride, dilation)


@pytest.mark.parametrize("case", ["cpu", "training", "2d", "dilation 1", "forced"])
def test_conv_nd_counts_the_route_it_takes(monkeypatch, case):
    """The CPU, a graph to build and a 2D input run ``F.conv2d``/``F.conv3d``
    as before and count a direct dilated convolution; dilation 1 counts
    nothing; with the route forced on the phase convolution runs."""
    g = torch.Generator().manual_seed(2)
    dims = 2 if case == "2d" else 3
    x = torch.randn((1, 3) + (13,) * dims, generator=g)
    w = torch.randn((4, 3) + (3,) * dims, generator=g, requires_grad=case == "training")
    b = torch.randn(4, generator=g)
    dilation = 1 if case == "dilation 1" else 2
    conv = F.conv2d if dims == 2 else F.conv3d
    calls, phase_conv3d = [], L.phase_conv3d
    if case == "forced":
        monkeypatch.setattr(L, "phase_route", lambda *a: True)
    monkeypatch.setattr(L, "phase_conv3d", lambda *a: calls.append(a) or phase_conv3d(*a))
    before = (L.phase_convs, L.direct_dilated_convs)
    with torch.set_grad_enabled(case == "training"):
        y = L.conv_nd(x, w, b, dilation=dilation)
    exact = {} if case == "forced" else dict(rtol=0, atol=0)
    torch.testing.assert_close(y, conv(x, w, b, dilation=dilation), **exact)
    counted = (L.phase_convs - before[0], L.direct_dilated_convs - before[1])
    assert counted == {"forced": (1, 0), "dilation 1": (0, 0)}.get(case, (0, 1))
    assert len(calls) == (case == "forced")


def _pair(seed=3):
    """resnet8 at units 32 with batch norm, its statistics redrawn so that
    they matter, in both packages."""
    rng = np.random.default_rng(seed)
    spec, params, state = jfactory.new_picker("resnet8", units=32, bn=True, seed=seed, dims=3)

    def leaf(path, v):
        name = jax.tree_util.keystr(path)
        v = np.asarray(v, np.float32)
        if "'var'" in name or "'scale'" in name:
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if "'mean'" in name or "'bias'" in name:
            return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        return v

    params = jax.tree_util.tree_map_with_path(leaf, params)
    state = jax.tree_util.tree_map_with_path(leaf, state)
    model = tfactory.picker_from_numpy(make_picker_spec("resnet8", units=32, bn=True, dims=3),
                                       params, state)
    return spec, params, state, model


def test_dense_3d_picker_on_the_phase_route_matches_direct_and_jax(monkeypatch):
    """One receptive field and a little more (71 + (1, 2, 3)): the dense
    form's 7 dilated convolutions on the phase route give the direct
    route's scores and the JAX picker's within 1e-4."""
    spec, params, state, model = _pair()
    assert spec.width == 71
    x = np.random.default_rng(4).normal(size=(1, 71, 72, 73)).astype(np.float32)
    with torch.no_grad():
        direct = model(torch.from_numpy(x), pad=False).numpy()
        monkeypatch.setattr(L, "phase_route",
                            lambda x, w, b, stride, dilation: x.dim() == 5 and dilation > 1
                            and stride == 1)
        before = L.phase_convs
        phase = model(torch.from_numpy(x), pad=False).numpy()
    assert L.phase_convs - before == 7
    want, _ = apply_picker(spec, params, jnp.asarray(x), state=state, dense=True, pad=False)
    want = np.asarray(want)
    assert phase.shape == direct.shape == want.shape == (1, 1, 2, 3)
    np.testing.assert_allclose(phase, direct, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(phase, want, atol=1e-4, rtol=1e-4)
