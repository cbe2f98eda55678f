"""The port's denoiser training against the JAX package's, on the CPU:
samplers, the optimizer additions, ``train_denoiser`` and checkpoints.

Tolerances, each with its reason:

* samplers (paired micrographs, HDF5 stacks): bit-equal batches for a seed,
  the same numpy generator calls in the same order;
* sgd with nesterov momentum and decayed weights against optax: rtol 1e-5,
  atol 1e-6 over five steps, a few float32 ulps at 1 (the same formulas,
  rounded in another order);
* ``train_denoiser`` from the same weights on the same crops, three epochs
  of two steps: rows rtol 1e-4 (measured 1.1e-5 on this file's cases; the
  rows are printed rounded to 5 decimals); final parameters atol 1e-4 x
  the largest magnitude of their tensor for adagrad and sgd (measured 1e-7
  absolute), and ``ADAM_PARAM_TOL`` x lr for adam. XLA's and torch's
  float32 gradients sum in other orders, and adam moves a weight whose
  gradient is near rounding noise by up to ~lr a step whatever its size,
  so those last bits reach the weights (measured 0.079 x lr: 10x that);
* checkpoints read back exactly; outputs through the other package's
  model within rtol 1e-4, atol 1e-5 (float32 convolutions).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from topaz_tpu.denoise import train_denoiser as j_train_denoiser
from topaz_tpu.models import denoise as jmodels
from topaz_tpu.models import denoise_factory as jfactory
from topaz_tpu.train import denoise_data as jdata
from topaz_tpu_torch.denoise import Denoise, train_denoiser
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.models import denoise_factory as tfactory
from topaz_tpu_torch.train import denoise_data as tdata
from topaz_tpu_torch.train import trainer as ttrainer
from torch_threads import one_torch_thread  # noqa: F401

ADAM_PARAM_TOL = 0.8


def _pairs(tmp_path, n=10, shape=(64, 72), seed=0):
    """``n`` noise2noise pairs: one smooth image, two noise draws."""
    rng = np.random.default_rng(seed)
    a, b = tmp_path / "A", tmp_path / "B"
    a.mkdir(exist_ok=True)
    b.mkdir(exist_ok=True)
    for i in range(n):
        clean = np.cumsum(np.cumsum(rng.normal(size=shape), 0), 1) / 20
        for d in (a, b):
            mrc.write(str(d / f"m{i:02d}.mrc"),
                      (clean + rng.normal(size=shape)).astype(np.float32))
    return str(a), str(b)


def _same_batches(jsampler, tsampler, batch_size, shuffle):
    n = 0
    for (jx, jy), (tx, ty) in zip(jsampler.batches(batch_size, shuffle=shuffle),
                                  tsampler.batches(batch_size, shuffle=shuffle), strict=True):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        n += 1
    return n


@pytest.mark.parametrize("crop,cutoff", [(48, 0), (100, 1.5)])
def test_paired_images_samplers_bit_equal(tmp_path, crop, cutoff):
    a, b = _pairs(tmp_path)
    j = jdata.make_paired_images_samplers(a, b, crop=crop, holdout=0.2, cutoff=cutoff)
    t = tdata.make_paired_images_samplers(a, b, crop=crop, holdout=0.2, cutoff=cutoff)
    assert [s.paths_a for s in t] == [s.paths_a for s in j]
    assert len(t[0]) == 8 and len(t[1]) == 2
    for epoch in range(3):  # the generators advance alike over epochs
        assert _same_batches(j[0], t[0], 3, shuffle=True) == 3
        assert _same_batches(j[1], t[1], 3, shuffle=False) == 1
    x = next(t[0].batches(8))[0]
    assert x.shape == (8, min(crop, 64), min(crop, 64)) and x.dtype == np.float32


def test_hdf5_samplers_bit_equal(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(1)
    path = str(tmp_path / "pairs.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("images", data=rng.normal(size=(14, 40, 40)).astype(np.float32))
    j = jdata.make_hdf5_samplers(path, holdout=0.3, cutoff=2.0)
    t = tdata.make_hdf5_samplers(path, holdout=0.3, cutoff=2.0)
    assert (len(t[0]), len(t[1])) == (len(j[0]), len(j[1])) == (5, 2)
    for _ in range(2):
        assert _same_batches(j[0], t[0], 2, shuffle=True) == 3
        assert _same_batches(j[1], t[1], 2, shuffle=False) == 1


@pytest.mark.parametrize("kind,wd", [("sgd", 0.0), ("sgd", 0.01), ("adam", 0.05),
                                     ("adagrad", 0.01)])
def test_nesterov_and_weight_decay_match_optax(kind, wd):
    rng = np.random.default_rng(2)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(5)]
    if kind == "sgd":
        jopt = optax.sgd(1e-2, momentum=0.9, nesterov=True)
        topt_kw = dict(momentum=0.9, nesterov=True)
    else:
        from topaz_tpu.train.trainer import make_optimizer

        jopt, topt_kw = make_optimizer(1e-2, kind), {}
    if wd > 0:
        jopt = optax.chain(optax.add_decayed_weights(wd), jopt)
    jparams = [jnp.asarray(p) for p in params0]
    jstate = jopt.init(jparams)
    tparams = [torch.tensor(p) for p in params0]
    topt = ttrainer.make_optimizer(tparams, 1e-2, kind, weight_decay=wd, **topt_kw)
    for g in grads:
        updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.step([torch.tensor(x) for x in g])
        for got, want in zip(tparams, jparams):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="nesterov"):
        ttrainer.make_optimizer(tparams, 1e-2, "adam", nesterov=True)


def _rows(text):
    """(train, val, best) of each epoch row printed by train_denoiser."""
    rows = [line.split("\t") for line in text.replace("\r", "\n").split("\n")
            if line.startswith("# [")]
    return np.array([[float(v) for v in r[1:]] for r in rows])


@pytest.mark.parametrize("optim", ["adagrad", "adam", "sgd"])
@pytest.mark.parametrize("loss_fn", ["L0", "L1", "L2"])
def test_train_denoiser_matches_jax(tmp_path, capsys, loss_fn, optim):
    a, b = _pairs(tmp_path)
    meta, jparams = jfactory.new_denoiser("unet-small", nf=8, base_width=7, seed=4)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    kw = dict(loss_fn=loss_fn, optim=optim, lr=1e-3, batch_size=4, num_epochs=3,
              save_best=True, save_interval=2)
    capsys.readouterr()
    j_out = j_train_denoiser(meta, jparams, *jdata.make_paired_images_samplers(a, b, crop=48,
                                                                               holdout=0.2),
                             save_prefix=str(tmp_path / "jax" / "m"), **kw)
    want_rows = _rows(capsys.readouterr().out)
    model = tfactory.denoiser_from_numpy(meta, jparams)
    got_model = train_denoiser(model, *tdata.make_paired_images_samplers(a, b, crop=48,
                                                                         holdout=0.2),
                               save_prefix=str(tmp_path / "port" / "m"), **kw)
    got_rows = _rows(capsys.readouterr().out)
    assert got_model is model and want_rows.shape == got_rows.shape == (3, 3)
    np.testing.assert_allclose(got_rows, want_rows, rtol=1e-4)
    _, got = tfactory.denoiser_to_numpy(model)
    for mod, convs in jax.tree_util.tree_map(np.asarray, j_out).items():
        for idx, p in convs.items():
            for k in ("w", "b"):
                atol = ADAM_PARAM_TOL * kw["lr"] if optim == "adam" else \
                    1e-4 * np.abs(p[k]).max()
                np.testing.assert_allclose(got[mod][idx][k], p[k], rtol=0, atol=atol)
    # save-best and --save-interval checkpoints, named alike
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert "m_epoch2.npz" in os.listdir(tmp_path / "port")


def test_train_denoiser_guards(tmp_path):
    a, b = _pairs(tmp_path, n=3, shape=(40, 40))
    model = tfactory.new_denoiser("unet", nf=4, base_width=5)
    train_s, val_s = tdata.make_paired_images_samplers(a, b, crop=16, holdout=0.0)
    with pytest.raises(ValueError, match="minimum input"):
        train_denoiser(model, train_s, val_s, batch_size=2, num_epochs=1, verbose=False)
    with pytest.raises(ValueError, match="not one of"):
        train_denoiser(model, train_s, val_s, loss_fn="L3", num_epochs=1)
    with pytest.raises(ValueError, match="float32"):
        Denoise("unet-small", device="cpu", dtype="bf16").train(train_s, val_s)


def _forward_jax(meta, params, x):
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    return np.asarray(jmodels.APPLY_FNS[meta["arch"]](tree, jnp.asarray(x)[..., None],
                                                      dims=meta["dims"]))[..., 0]


@pytest.mark.parametrize("arch,dims", [("unet-small", 2), ("affine", 2), ("fcnet", 3)])
def test_checkpoints_load_both_ways(tmp_path, arch, dims):
    """The port's ``save_denoiser`` loads in JAX's ``load_denoiser`` and the
    reverse; each package's model gives the other's output."""
    model = tfactory.new_denoiser(arch, nf=4, base_width=5, dims=dims, seed=5)
    if arch == "affine":  # zero at init: give it weights to carry
        with torch.no_grad():
            model.filter.weight.normal_(generator=torch.Generator().manual_seed(0))
    port_path = str(tmp_path / "port.npz")
    tfactory.save_denoiser(port_path, model.meta, model)
    meta, params = jfactory.load_denoiser(port_path)
    assert meta == model.meta
    shape = (1, 40, 36) if dims == 2 else (1, 20, 18, 16)
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)[:, None])[:, 0].numpy()
    np.testing.assert_allclose(got, _forward_jax(meta, params, x), rtol=1e-4, atol=1e-5)

    jmeta, jparams = jfactory.new_denoiser(arch, nf=4, base_width=5, dims=dims, seed=6)
    jax_path = str(tmp_path / "jax.npz")
    jfactory.save_denoiser(jax_path, jmeta, jparams)
    loaded = tfactory.load_denoiser(jax_path, device="cpu")
    assert loaded.meta == jmeta
    _, back = tfactory.denoiser_to_numpy(loaded)
    for k, v in jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jparams)):
        node = back
        for part in k:
            node = node[part.key]
        np.testing.assert_array_equal(node, v)
    with torch.no_grad():
        got = loaded(torch.from_numpy(x)[:, None])[:, 0].numpy()
    np.testing.assert_allclose(got, _forward_jax(jmeta, jparams, x), rtol=1e-4, atol=1e-5)
