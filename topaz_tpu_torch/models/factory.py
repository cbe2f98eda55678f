"""Picker loading, creation and saving (port of
topaz_tpu/models/factory.py:88-150).

Pretrained aliases resolve to the weight files that ship with the JAX
package (topaz_tpu/pretrained/detector/<stem>.npz), read by path and
read-only; other ``.npz`` checkpoints load the same way. Checkpoints hold
the JAX package's layout: ``__meta__`` (arch and constructor kwargs),
``params:`` with HWIO kernels and ``state:`` with batchnorm running
statistics. ``picker_from_numpy`` and ``picker_to_numpy`` carry such trees
into the port's OIHW module and back (DHWIO <-> OIDHW for 3D pickers), so
that either package loads the other's checkpoints; ``dims`` travels in the
meta. A checkpoint of an autoencoder run also holds the decoder under
``params:generative``, as the JAX package writes it; loading a picker
ignores it.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from topaz_tpu_torch.models.layers import ConvSpec, ResidSpec
from topaz_tpu_torch.models.picker import Picker, PickerSpec, init_picker, make_picker_spec
from topaz_tpu_torch.utils.serialize import load_checkpoint, save_checkpoint

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PRETRAINED_DIR = os.path.join(_REPO_DIR, "topaz_tpu", "pretrained", "detector")

# alias -> (arch, units, weight file stem); mirrors topaz/model/factory.py:33-51
PRETRAINED_PICKERS = {
    "resnet16": ("resnet16", 64, "resnet16_u64"),
    "resnet16_u64": ("resnet16", 64, "resnet16_u64"),
    "resnet16_u32": ("resnet16", 32, "resnet16_u32"),
    "resnet8": ("resnet8", 64, "resnet8_u64"),
    "resnet8_u64": ("resnet8", 64, "resnet8_u64"),
    "resnet8_u32": ("resnet8", 32, "resnet8_u32"),
}


def available_pretrained():
    """Pretrained picker aliases whose weights ship with the repo."""
    return {alias for alias, (_, _, stem) in PRETRAINED_PICKERS.items()
            if os.path.exists(os.path.join(PRETRAINED_DIR, stem + ".npz"))}


def _spec_from_meta(meta: Dict) -> PickerSpec:
    return make_picker_spec(
        meta["arch"],
        units=meta.get("units", 32),
        bn=meta.get("bn", False),
        dropout=meta.get("dropout", 0.0),
        pooling=meta.get("pooling"),
        unit_scaling=meta.get("unit_scaling", 2),
        dims=meta.get("dims", 2),
        activation=meta.get("activation"),
    )


def _oihw(w) -> torch.Tensor:
    """HWIO kernel -> OIHW, or DHWIO -> OIDHW."""
    w = np.asarray(w)
    axes = (w.ndim - 1, w.ndim - 2) + tuple(range(w.ndim - 2))
    return torch.from_numpy(np.array(w.transpose(axes), dtype=np.float32, order="C"))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _hwio(w: torch.Tensor) -> np.ndarray:
    """OIHW kernel -> HWIO, or OIDHW -> DHWIO."""
    axes = tuple(range(2, w.dim())) + (1, 0)
    return np.ascontiguousarray(w.detach().cpu().numpy().transpose(axes))


def _np(v: torch.Tensor) -> np.ndarray:
    return v.detach().cpu().numpy().copy()


def picker_to_numpy(model: Picker) -> Tuple[Dict, Dict]:
    """(params, state) numpy trees of ``model`` in the JAX package's layout,
    the inverse of ``picker_from_numpy``."""
    feats, feat_state = {}, {}
    for i, (lspec, layer) in enumerate(zip(model.spec.features, model.layers)):
        if not isinstance(lspec, (ConvSpec, ResidSpec)):
            continue
        p, s = {}, {}
        for name in ("conv", "conv0", "conv1", "proj"):
            if hasattr(layer, name + "_w"):
                p[name + "_w"] = _hwio(getattr(layer, name + "_w"))
            if hasattr(layer, name + "_b"):
                p[name + "_b"] = _np(getattr(layer, name + "_b"))
        for bn in ("bn", "bn0", "bn1"):
            if hasattr(layer, bn + "_scale"):
                p[bn] = {"scale": _np(getattr(layer, bn + "_scale")),
                         "bias": _np(getattr(layer, bn + "_bias"))}
                s[bn] = {"mean": _np(getattr(layer, bn + "_mean")),
                         "var": _np(getattr(layer, bn + "_var"))}
        if hasattr(layer, "prelu"):
            p["prelu"] = _np(layer.prelu)
        feats[str(i)] = p
        if s:
            feat_state[str(i)] = s
    params = {"features": feats, "classifier": {"w": _hwio(model.classifier_w),
                                                "b": _np(model.classifier_b)}}
    return params, {"features": feat_state}


def picker_from_numpy(spec: PickerSpec, params: Dict, state: Dict) -> Picker:
    """The port's module for a JAX parameter tree given as numpy arrays:
    ``params`` = {"features": {"<i>": {...}}, "classifier": {"w", "b"}},
    ``state`` = {"features": {"<i>": {"bn": {"mean", "var"}}}} (batchnorm
    running statistics, may be empty). Module is in eval mode, on the CPU."""
    model = Picker(spec)
    feats = params["features"]
    feat_state = (state or {}).get("features", {})
    with torch.no_grad():
        for i, (lspec, layer) in enumerate(zip(spec.features, model.layers)):
            if not isinstance(lspec, (ConvSpec, ResidSpec)):
                continue
            p, s = feats[str(i)], feat_state.get(str(i), {})
            for name in ("conv", "conv0", "conv1", "proj"):
                if name + "_w" in p:
                    getattr(layer, name + "_w").copy_(_oihw(p[name + "_w"]))
                if name + "_b" in p:
                    getattr(layer, name + "_b").copy_(_vec(p[name + "_b"]))
            for bn in ("bn", "bn0", "bn1"):
                if bn in p:
                    getattr(layer, bn + "_scale").copy_(_vec(p[bn]["scale"]))
                    getattr(layer, bn + "_bias").copy_(_vec(p[bn]["bias"]))
                    getattr(layer, bn + "_mean").copy_(_vec(s[bn]["mean"]))
                    getattr(layer, bn + "_var").copy_(_vec(s[bn]["var"]))
            if "prelu" in p:
                layer.prelu.copy_(_vec(p["prelu"]))
        model.classifier_w.copy_(_oihw(params["classifier"]["w"]))
        model.classifier_b.copy_(_vec(params["classifier"]["b"]))
    return model.eval()


def load_picker(name_or_path: str, device="cuda") -> Picker:
    """Load a picker by pretrained alias, ``.npz`` checkpoint path or
    reference ``.sav`` path (state dict or whole pickled module, read by
    ``models.convert`` without unpickling code), in eval mode on
    ``device``."""
    from topaz_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if name_or_path in PRETRAINED_PICKERS:
        _, _, stem = PRETRAINED_PICKERS[name_or_path]
        path = os.path.join(PRETRAINED_DIR, stem + ".npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"pretrained weights {stem!r} are not bundled ({path}); "
                f"available aliases with weights: {sorted(available_pretrained())}")
    else:
        path = name_or_path
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"model {name_or_path!r} is neither a pretrained alias "
            f"({sorted(PRETRAINED_PICKERS)}) nor a file")
    if path.endswith(".npz"):
        meta, trees = load_checkpoint(path)
        params, state = trees["params"], trees.get("state", {"features": {}})
    else:
        from topaz_tpu_torch.models.convert import convert_picker_sav

        meta, params, state = convert_picker_sav(path)
    return picker_from_numpy(_spec_from_meta(meta), params, state).to(device)


def save_picker(path: str, model: Picker, decoder=None) -> None:
    """Write a picker checkpoint that the JAX package's ``load_picker``
    reads (topaz_tpu/models/factory.py:121-139), with an autoencoder run's
    ``decoder`` (a ``models.generative.Generator``) beside the picker, as
    topaz_tpu/training.py:440-445 saves it."""
    from topaz_tpu_torch.models.generative import generator_to_numpy

    meta = {"arch": model.spec.arch, "dims": model.spec.dims}
    meta.update(dict(model.spec.config))
    params, state = picker_to_numpy(model)
    if decoder is not None:
        params["generative"] = generator_to_numpy(decoder)
    save_checkpoint(path, meta, params=params, state=state)


def new_picker(arch: str, units=32, bn: bool = False, dropout: float = 0.0,
               pooling=None, unit_scaling: int = 2, dims: int = 2, seed: int = 0,
               device="cuda") -> Picker:
    """A fresh picker for an arch name (topaz_tpu/models/factory.py:142-150),
    its weights drawn from a CPU generator seeded with ``seed``, on
    ``device``."""
    from topaz_tpu_torch.device import resolve_device

    device = resolve_device(device)
    spec = make_picker_spec(arch, units=units, bn=bn, dropout=dropout, pooling=pooling,
                            unit_scaling=unit_scaling, dims=dims)
    return init_picker(spec, torch.Generator().manual_seed(seed)).to(device)
