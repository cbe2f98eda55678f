"""Picker loading (port of topaz_tpu/models/factory.py:88-118).

Pretrained aliases resolve to the weight files that ship with the JAX
package (topaz_tpu/pretrained/detector/<stem>.npz), read by path and
read-only; other ``.npz`` checkpoints load the same way. JAX parameter trees
hold HWIO kernels; ``picker_from_numpy`` turns them into the port's OIHW
module.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from topaz_tpu_torch.models.layers import ConvSpec, ResidSpec
from topaz_tpu_torch.models.picker import Picker, PickerSpec, make_picker_spec
from topaz_tpu_torch.utils.serialize import load_checkpoint

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
    """HWIO kernel -> OIHW."""
    return torch.from_numpy(np.array(np.asarray(w).transpose(3, 2, 0, 1),
                                     dtype=np.float32, order="C"))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


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
    """Load a picker by pretrained alias or ``.npz`` checkpoint path, in
    eval mode on ``device``."""
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
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only .npz picker checkpoints load in topaz_tpu_torch; "
            f"reading reference .sav checkpoints is not yet ported")
    meta, trees = load_checkpoint(path)
    spec = _spec_from_meta(meta)
    model = picker_from_numpy(spec, trees["params"], trees.get("state", {"features": {}}))
    return model.to(device)
