"""The port's dense pickers against the JAX package's ``apply_picker``.

The same parameters (numpy, given to both stacks through
``picker_from_numpy``) and the same images go through both on the CPU.
Tolerance atol 1e-4, rtol 1e-4: float32 convolutions sum in another order
in XLA and in PyTorch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.models import factory as jfactory
from topaz_tpu.models.picker import apply_picker
from topaz_tpu_torch.models import factory as tfactory
from topaz_tpu_torch.models.picker import make_picker_spec as t_make_picker_spec
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _numpy_tree(tree, rng):
    """The tree as numpy, batchnorm statistics and PReLU slopes drawn at
    random so that they matter."""
    def leaf(path, v):
        v = np.asarray(v, np.float32)
        name = jax.tree_util.keystr(path)
        if "'var'" in name or "'scale'" in name:
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if "'mean'" in name or "'bias'" in name or "'prelu'" in name:
            return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_scores(spec, params, state, x):
    y, _ = apply_picker(spec, jax.tree_util.tree_map(jnp.asarray, params),
                        jnp.asarray(x), state=jax.tree_util.tree_map(jnp.asarray, state),
                        dense=True)
    return np.asarray(y)


@pytest.mark.parametrize("arch,kw", [
    ("resnet8", {}),
    ("resnet8", {"pooling": "max", "bn": True}),
    ("resnet16", {}),
    ("conv31", {}),
    ("conv31", {"pooling": "avg", "bn": True}),
])
def test_dense_scores_match_jax(arch, kw):
    rng = np.random.default_rng(0)
    spec, params, state = jfactory.new_picker(arch, units=4, seed=1, **kw)
    params, state = _numpy_tree(params, rng), _numpy_tree(state, rng)
    model = tfactory.picker_from_numpy(
        t_make_picker_spec(arch, units=4, **kw), params, state)
    x = rng.normal(size=(2, 64, 72)).astype(np.float32)
    want = _jax_scores(spec, params, state, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_resnet8_u32_pretrained_matches_jax():
    spec, params, state = jfactory.load_picker("resnet8_u32")
    model = tfactory.load_picker("resnet8_u32", device="cpu")
    assert [p.device.type for p in model.parameters()] == ["cpu"] * len(list(model.parameters()))
    assert model.spec.width == spec.width
    # the factory's own module and one built from the JAX tree hold the same weights
    same = tfactory.picker_from_numpy(model.spec, params, state)
    for a, b in zip(model.state_dict().values(), same.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x = np.random.default_rng(2).normal(size=(1, 96, 96)).astype(np.float32)
    want = _jax_scores(spec, params, state, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_load_picker_refuses_what_is_not_ported(tmp_path):
    """A file that is no checkpoint raises the .sav reader's error (the
    reader itself: tests/test_torch_sav.py); the u64 aliases, whose
    weights are not in the repo, raise FileNotFoundError."""
    from topaz_tpu_torch.models.convert import SavFormatError

    sav = tmp_path / "model.sav"
    sav.write_bytes(b"not a checkpoint")
    with pytest.raises(SavFormatError, match="does not read this file"):
        tfactory.load_picker(str(sav), device="cpu")
    with pytest.raises(FileNotFoundError, match="not bundled"):
        tfactory.load_picker("resnet16", device="cpu")
