"""The port's strided train-mode picker and its checkpoints against the JAX
package.

The same parameters (a JAX-initialized tree with random batchnorm
statistics, carried into the port by ``picker_from_numpy``) and the same
crops of the receptive field go through ``apply_picker(dense=False,
pad=False)`` and ``Picker(dense=False)``: scores agree to atol/rtol 1e-4
(float32 convolutions sum in other orders in XLA and PyTorch), as in
tests/test_torch_picker.py; so do the batchnorm running statistics after a
train-mode forward. The gradient of every parameter agrees to rtol 1e-4,
atol 1e-3 of the largest gradient of the tree: XLA's float32 gradient on
the CPU is the less exact one (resnet8 with max pooling and batchnorm: the
first kernel's gradient lies 3.7e-4 of the largest from JAX's own float64
gradient, the port's float32 one 2.3e-6; the two float64 gradients agree
to 3e-13). Checkpoints cross both ways: each package's ``load_picker``
reads the other's and scores the same."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.models import factory as jfactory
from topaz_tpu.models.picker import apply_picker
from topaz_tpu_torch.models import factory as tfactory
from topaz_tpu_torch.models.layers import dropout
from topaz_tpu_torch.models.picker import init_picker
from topaz_tpu_torch.models.picker import make_picker_spec as t_make_picker_spec
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)

ARCHS = [
    ("resnet8", {}),
    ("resnet8", {"bn": True}),
    ("resnet8", {"pooling": "max", "bn": True}),
    ("resnet6", {}),
    ("conv31", {"bn": True}),
]


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


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, atol=1e-4):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol, err_msg=k)


def _grad_tree(model):
    """The gradients of ``model``'s parameters as a JAX-layout tree."""
    params, _ = tfactory.picker_to_numpy(model)
    grads = tfactory.picker_to_numpy(_with_grads(model))[0]
    assert jax.tree_util.tree_structure(grads) == jax.tree_util.tree_structure(params)
    return grads


def _with_grads(model):
    import copy

    out = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(out.parameters(), model.parameters()):
            p.copy_(q.grad)
    return out


@pytest.mark.parametrize("arch,kw", ARCHS)
def test_strided_train_forward_and_gradients_match_jax(arch, kw):
    rng = np.random.default_rng(0)
    spec, params, state = jfactory.new_picker(arch, units=4, seed=1, **kw)
    params, state = _numpy_tree(params, rng), _numpy_tree(state, rng)
    model = tfactory.picker_from_numpy(t_make_picker_spec(arch, units=4, **kw), params, state)
    assert model.spec.width == spec.width
    x = rng.normal(size=(16, spec.width, spec.width)).astype(np.float32)
    weights = rng.normal(size=16).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)

    # eval-mode strided form: one logit a crop
    want, _ = apply_picker(spec, jp, jnp.asarray(x), state=js, dense=False, pad=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x), dense=False)
    assert got.shape == want.shape == (16, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # train mode: batch statistics, running statistics, gradients
    def loss(p):
        y, new_state = apply_picker(spec, p, jnp.asarray(x), state=js, dense=False,
                                    pad=False, train=True)
        return jnp.sum(y.reshape(-1) * weights), (y, new_state)

    jgrads, (want, want_state) = jax.grad(loss, has_aux=True)(jp)
    got = model(torch.from_numpy(x), dense=False, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _assert_trees_close(tfactory.picker_to_numpy(model)[1], want_state)
    (got.reshape(-1) * torch.from_numpy(weights)).sum().backward()
    scale = max(float(np.abs(v).max()) for v in _leaves(jgrads).values())
    _assert_trees_close(_grad_tree(model), jgrads, atol=1e-3 * scale)


def test_init_picker_draws_at_the_jax_scales():
    spec, params, state = jfactory.new_picker("resnet8", units=8, bn=True, seed=0)
    model = init_picker(t_make_picker_spec("resnet8", units=8, bn=True),
                        torch.Generator().manual_seed(0))
    got_params, got_state = tfactory.picker_to_numpy(model)
    want, got = _leaves(params), _leaves(got_params)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if "['bn" in k:
            np.testing.assert_array_equal(got[k], want[k])
        elif got[k].size > 8:
            # U(-b, b), b = 1/sqrt(fan_in): the same bound in both packages
            bound = np.abs(want[k]).max()
            assert np.abs(got[k]).max() <= bound * 1.25 and np.abs(got[k]).max() >= bound * 0.75, k
    _assert_trees_close(got_state, state)
    # the same seed gives the same weights, whatever the device
    again = init_picker(model.spec, torch.Generator().manual_seed(0))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dropout_keeps_and_scales():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 50)
    y = dropout(x, 0.25, g)
    assert set(torch.unique(y).tolist()) == {0.0, torch.tensor(1 / 0.75).item()}
    assert abs(float((y > 0).float().mean()) - 0.75) < 0.01
    spec = t_make_picker_spec("resnet8", units=4, dropout=0.5)
    model = init_picker(spec, torch.Generator().manual_seed(0))
    crops = torch.randn(4, spec.width, spec.width, generator=g)
    with torch.no_grad():
        a = model(crops, dense=False, train=True, generator=torch.Generator().manual_seed(1))
        b = model(crops, dense=False, train=True, generator=torch.Generator().manual_seed(1))
        c = model(crops, dense=False, train=True, generator=torch.Generator().manual_seed(2))
        d = model(crops, dense=False, train=False)
        e = model(crops, dense=False, train=True)  # no generator: no dropout
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    torch.testing.assert_close(d, e, rtol=0, atol=0)


@pytest.mark.parametrize("arch,kw", [("resnet8", {"bn": True}),
                                     ("conv31", {"pooling": "avg", "bn": True})])
def test_checkpoints_cross_both_ways(tmp_path, arch, kw):
    rng = np.random.default_rng(3)
    spec, params, state = jfactory.new_picker(arch, units=4, seed=2, **kw)
    params, state = _numpy_tree(params, rng), _numpy_tree(state, rng)
    x = rng.normal(size=(1, 64, 72)).astype(np.float32)

    def jax_scores(spec, params, state):
        y, _ = apply_picker(spec, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
                            state=jax.tree_util.tree_map(jnp.asarray, state), dense=True)
        return np.asarray(y)

    # JAX -> port
    jfactory.save_picker(str(tmp_path / "jax.npz"), spec, params, state)
    model = tfactory.load_picker(str(tmp_path / "jax.npz"), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = jax_scores(spec, params, state)
    np.testing.assert_allclose(got, want, **TOL)

    # port -> JAX, after a train-mode forward moved the running statistics
    model(torch.from_numpy(rng.normal(size=(8, spec.width, spec.width)).astype(np.float32)),
          dense=False, train=True)
    tfactory.save_picker(str(tmp_path / "port.npz"), model)
    jspec, jparams, jstate = jfactory.load_picker(str(tmp_path / "port.npz"))
    assert jspec == spec
    _assert_trees_close(jstate, tfactory.picker_to_numpy(model)[1])
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jax_scores(jspec, jparams, jstate), **TOL)
    assert not np.allclose(got, want)
