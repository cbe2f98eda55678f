"""The autoencoder regularizer of the port against the JAX package's: the
decoder (``models/generative.py``) and one autoencoder train step.

The decoder's forward agrees with ``apply_generator`` to atol 1e-5 on the
same weights (float32 transposed convolutions and batch statistics summed
in other orders). One train step of the picker and the decoder runs with
plain SGD at lr 1 in both packages, so each parameter's change is its
gradient: the metrics (``recon_error`` among them) and the gradients agree
to rtol 1e-3, atol 1e-5, the tolerance of the whole-run tests
(``test_torch_train_run.py``). The step's crops differ in mean and carry a
blob each, so that their latents differ: on crops of pure noise alike in
distribution the latents nearly coincide, the decoder's first batchnorm
divides by a tiny batch std, and float32 rounding in either package moves
the gradients by up to ~10% (measured against float64)."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.models import generative as jgen
from topaz_tpu.models.picker import init_picker as j_init_picker
from topaz_tpu.models.picker import make_picker_spec as j_spec
from topaz_tpu.train import trainer as jtrainer
from topaz_tpu.train.methods import make_loss_fn as j_loss_fn
from topaz_tpu_torch.models import generative as tgen
from topaz_tpu_torch.models.factory import picker_from_numpy, picker_to_numpy
from topaz_tpu_torch.models.picker import make_picker_spec as t_spec
from topaz_tpu_torch.train.methods import make_loss_fn as t_loss_fn
from topaz_tpu_torch.train.trainer import init_train_state, make_train_step
from topaz_tpu_torch import training as ttraining
from torch_threads import one_torch_thread  # noqa: F401


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("nin,units,depth", [(16, 4, 1), (8, 2, 2), (12, 3, 3)])
def test_decoder_forward_matches_jax(nin, units, depth):
    params, layer_spec = jgen.init_generator(nin, jax.random.PRNGKey(depth), units=units,
                                             depth=depth)
    params = _np_tree(params)
    rng = np.random.default_rng(depth)
    for bn in (k for k in params if k.startswith("bn")):  # move batchnorm off (1, 0)
        params[bn] = {"scale": rng.uniform(0.5, 1.5, params[bn]["scale"].shape).astype(np.float32),
                      "bias": rng.normal(size=params[bn]["bias"].shape).astype(np.float32)}
    z = rng.normal(size=(5, nin)).astype(np.float32)
    want = np.asarray(jgen.apply_generator(params, jnp.asarray(z), train=True))[..., 0]
    model = tgen.generator_from_numpy(params)
    assert model.spec == layer_spec == jgen.layer_spec_for(depth)
    got = model(torch.from_numpy(z)).detach().numpy()
    assert got.shape == (5, jgen.generator_width(depth), jgen.generator_width(depth))
    assert model.width == tgen.generator_width(depth) == jgen.generator_width(depth)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_decoder_weights_round_trip():
    params, _ = jgen.init_generator(20, jax.random.PRNGKey(0), units=4, depth=2)
    params = _np_tree(params)
    back = tgen.generator_to_numpy(tgen.generator_from_numpy(params))
    assert sorted(back) == sorted(params) == ["0", "1", "2", "3", "bn0", "bn1", "bn2"]
    for key in params:
        assert sorted(back[key]) == sorted(params[key])
        for leaf in params[key]:
            np.testing.assert_array_equal(back[key][leaf], params[key][leaf])
            assert back[key][leaf].dtype == np.float32


def test_decoder_init_draws_at_the_jax_scale():
    model = tgen.init_generator(128, torch.Generator().manual_seed(0), units=32, depth=3)
    jparams, _ = jgen.init_generator(128, jax.random.PRNGKey(0), units=32, depth=3)
    tree = tgen.generator_to_numpy(model)
    for key, value in jparams.items():
        for leaf, want in value.items():
            got = tree[key][leaf]
            assert got.shape == np.asarray(want).shape
            if leaf != "w":  # batchnorm: scale 1, bias 0
                np.testing.assert_array_equal(got, np.asarray(want))
                continue
            k, _, cout, _ = got.shape
            bound = 1.0 / np.sqrt(cout * k * k)
            assert np.abs(got).max() <= bound
            assert np.abs(got).max() > 0.95 * bound  # uniform over the whole range
            np.testing.assert_allclose(got.std(), bound / np.sqrt(3), rtol=0.1)


def _ae_step_both(method, crops, labels, autoencoder=1.0, l2=0.0):
    """One SGD(lr=1) step of resnet8 (units 4) with a decoder (depth 3,
    ngf 4) in each package from the same weights: (metrics, gradients) of
    each, the gradients as JAX trees."""
    spec = j_spec("resnet8", units=4)
    params, state = j_init_picker(spec, jax.random.PRNGKey(0))
    gen, _ = jgen.init_generator(spec.latent_dim, jax.random.PRNGKey(1), units=4, depth=3)
    params = _np_tree({**params, "generative": gen})
    state = _np_tree(state)
    pi = 0.1
    loss_fn, header, _ = j_loss_fn(method, pi)
    opt = jtrainer.make_optimizer(1.0, "sgd")
    jstep = jtrainer.make_train_step(spec, loss_fn, opt, l2=l2, autoencoder=autoencoder,
                                     generator_width=jgen.generator_width(3))
    jstate = jtrainer.init_train_state(spec, params, state, opt, pi)
    new, jm = jstep(jstate, jnp.asarray(crops), jnp.asarray(labels))
    jgrad = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), params,
                                   _np_tree(new.params))

    model = picker_from_numpy(t_spec("resnet8", units=4), params, state)
    decoder = tgen.generator_from_numpy(params["generative"])
    tstate = init_train_state(model, pi, lr=1.0, optim="sgd", decoder=decoder)
    tloss_fn = t_loss_fn(method, pi)[0]
    tm = make_train_step(tloss_fn, l2=l2, autoencoder=autoencoder)(
        tstate, torch.from_numpy(crops), torch.from_numpy(labels))
    after, _ = picker_to_numpy(model)
    after["generative"] = tgen.generator_to_numpy(decoder)
    tgrad = jax.tree_util.tree_map(lambda a, b: a - b, params, after)
    return ({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()},
            jgrad, tgrad)


@pytest.mark.parametrize("method,l2", [("GE-binomial", 0.0), ("PN", 1e-3)])
def test_autoencoder_step_matches_jax(method, l2):
    rng = np.random.default_rng(1)
    crops = rng.normal(size=(6, 71, 71)) + 2 * rng.normal(size=(6, 1, 1))
    yy, xx = np.mgrid[:71, :71]
    for crop in crops:
        cy, cx = rng.integers(20, 50, 2)
        crop += rng.uniform(2, 5) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                           / (2 * rng.uniform(3, 8) ** 2))
    crops = crops.astype(np.float32)
    labels = np.array([1, 1, 0, 0, 0, 0], dtype=np.float32)
    jm, tm, jgrad, tgrad = _ae_step_both(method, crops, labels, l2=l2)
    assert sorted(jm) == sorted(tm) and "recon_error" in tm
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, atol=1e-5, err_msg=k)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jgrad),
                                 jax.tree_util.tree_leaves(tgrad)):
        scale = max(float(np.abs(want).max()), 1e-8)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * max(1.0, scale),
                                   err_msg=jax.tree_util.keystr(path))
    # the decoder learns: its gradient is not zero
    assert max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(tgrad["generative"])) > 0


def test_autoencoder_with_dims_3_raises_a_value_error(tmp_path):
    args = argparse.Namespace(autoencoder=1.0, dims=3, device="cpu")
    with pytest.raises(ValueError, match="autoencoder regularizer .* is 2D only"):
        ttraining.train_model(args)
