"""The port's extra feature extractors (models/extras.py) against the JAX
package's apply functions, on the CPU.

Each port net is built at the small widths of tests/test_extras.py with
weights from a seeded ``torch.Generator``; its ``state_dict()`` as numpy
goes through the JAX package's ``extras_params_from_state_dict`` and the
same input through both. Features agree within 2e-4 (rtol and atol), the
JAX package's own tolerance for these nets at ``precision="highest"``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.models import extras as jextras
from topaz_tpu_torch.models import extras as textras
from torch_threads import one_torch_thread  # noqa: F401

CASES = {
    "msdensenet": (lambda: textras.MultiscaleDenseNet(base_units=8, ng=6, num_blocks=2),
                   lambda p, x, **kw: jextras.apply_multiscale_densenet(p, x, num_blocks=2, **kw),
                   (80, 84)),
    "densenet": (lambda: textras.DenseNet(init_units=8, ng=4, bn_size=2, fc_units=16,
                                          num_layers=3, bn=False),
                 lambda p, x, **kw: jextras.apply_densenet(p, x, num_layers=3, **kw),
                 (6, 10)),
    "rmsnet7": (lambda: textras.RMSNet7(units=[8, 8, 12, 12, 16]),
                lambda p, x, **kw: jextras.apply_rmsnet(p, x, "rmsnet7", **kw), (8, 4)),
    "rmsnet10": (lambda: textras.RMSNet10(units=[8, 8, 12, 12, 16]),
                 lambda p, x, **kw: jextras.apply_rmsnet(p, x, "rmsnet10", **kw), (8, 4)),
    "rmsnet": (lambda: textras.RMSNet(units=[4, 4, 4, 6, 6, 6, 6, 6, 6, 8, 8, 8]),
               lambda p, x, **kw: jextras.apply_rmsnet(p, x, "rmsnet", **kw), (4, 6)),
    "pyramidnet": (lambda: textras.PyramidNet(base_units=8, scales=[2, 4, 8]),
                   lambda p, x, **kw: jextras.apply_pyramidnet(p, x, scales=(2, 4, 8), **kw),
                   (12, 6)),
}


def _build(name, seed=0):
    model = CASES[name][0]()
    return textras.init_extras_(model, torch.Generator().manual_seed(seed)).eval()


def _numpy_state(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_extras_match_jax(name):
    model = _build(name)
    _, apply_fn, shape = CASES[name]
    if name == "msdensenet":
        hw = shape  # SAME blocks: any size past the 73-pixel head
    else:
        hw = (model.width + shape[0], model.width + shape[1])
    x = np.random.default_rng(1).normal(size=hw).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)[None, None]).numpy()[0]
    sd = _numpy_state(model)
    want = np.asarray(apply_fn(jextras.extras_params_from_state_dict(sd),
                               jnp.asarray(x)[None, :, :, None], precision="highest"))
    want = np.moveaxis(want[0], -1, 0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    # the port's loader takes the numpy state dict back
    other = textras.load_extras_state_dict(CASES[name][0](), sd).eval()
    with torch.no_grad():
        np.testing.assert_array_equal(other(torch.from_numpy(x)[None, None]).numpy()[0], got)


def test_widths_match_jax():
    assert textras.densenet_width(3) == jextras.densenet_width(3)
    assert textras.pyramidnet_width((2, 4, 8)) == jextras.pyramidnet_width((2, 4, 8))
    assert sorted(textras.EXTRA_ARCHS) == sorted(jextras.EXTRA_ARCHS)
    for name, entry in textras.EXTRA_ARCHS.items():
        assert entry["width"] == jextras.EXTRA_ARCHS[name]["width"], name
        if name != "msdensenet":  # the default-width nets, built on the meta device
            with torch.device("meta"):
                assert entry["module"]().width == entry["width"], name
    assert _build("densenet").width == jextras.densenet_width(3)


def test_both_loaders_refuse_batch_norm():
    sd = _numpy_state(_build("densenet"))
    sd["layers.0.bn1.weight"] = np.ones(8, np.float32)
    sd["layers.0.bn1.bias"] = np.zeros(8, np.float32)
    with pytest.raises(ValueError, match="looks like batch-norm") as want:
        jextras.extras_params_from_state_dict(sd)
    with pytest.raises(ValueError, match="looks like batch-norm") as got:
        textras.load_extras_state_dict(CASES["densenet"][0](), sd)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no batch norm"):
        textras.DenseNet(bn=True)
