"""Denoiser loading, creation and saving (port of
topaz_tpu/models/denoise_factory.py).

Pretrained aliases resolve to the weight files that ship with the JAX
package (topaz_tpu/pretrained/denoise/<stem>.npz), read by path and
read-only; other ``.npz`` checkpoints load the same way. JAX parameter
trees hold HWIO (DHWIO in 3D) kernels under reference module names;
``denoiser_from_numpy`` turns them into the port's OIHW (OIDHW) module and
``denoiser_to_numpy`` back, so ``save_denoiser`` writes the JAX package's
layout and each package loads the other's checkpoints.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import numpy as np
import torch
from torch import nn

from topaz_tpu_torch.models.denoise import init_denoiser, make_denoiser
from topaz_tpu_torch.utils.serialize import load_checkpoint, save_checkpoint

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PRETRAINED_DIR = os.path.join(_REPO_DIR, "topaz_tpu", "pretrained", "denoise")

# alias -> weight file stem (reference topaz/denoising/models.py:568-579)
PRETRAINED_DENOISERS = {
    "unet": "unet_L2_v0.2.2",
    "unet-small": "unet_small_L1_v0.2.2",
    "fcnn": "fcnn_L1_v0.2.2",
    "affine": "affine_L1_v0.2.2",
    "unet-v0.2.1": "unet_L2_v0.2.1",
    "unet-3d": "unet-3d-10a-v0.2.4",
    "unet-3d-10a": "unet-3d-10a-v0.2.4",
    "unet-3d-20a": "unet-3d-20a-v0.2.4",
}


def denoiser_from_numpy(meta: Dict, params: Dict) -> nn.Module:
    """The port's module for a JAX denoiser parameter tree given as numpy
    arrays: ``params[module][index] = {"w": HWIO or DHWIO, "b": (cout,)}``,
    or ``params["filter"] = {"w", "b"}`` for the affine model. The module
    holds ``meta`` as ``.meta`` and comes back in eval mode, on the CPU."""
    model = make_denoiser(meta)
    sd = {}
    for mod, entry in params.items():
        convs = {"": entry} if "w" in entry else entry
        for idx, p in convs.items():
            key = f"{mod}.{idx}." if idx else f"{mod}."
            w = np.asarray(p["w"], dtype=np.float32)
            n = w.ndim
            sd[key + "weight"] = torch.from_numpy(
                np.ascontiguousarray(w.transpose(n - 1, n - 2, *range(n - 2))))
            sd[key + "bias"] = torch.from_numpy(np.array(p["b"], dtype=np.float32))
    model.load_state_dict(sd, strict=True)
    model.meta = dict(meta)
    return model.eval()


def denoiser_to_numpy(model: nn.Module):
    """(meta, params) of a module in the JAX package's tree layout, the
    inverse of ``denoiser_from_numpy``."""
    params: Dict = {}
    for key, t in model.state_dict().items():
        *path, kind = key.split(".")
        a = t.detach().float().cpu().numpy()
        if kind == "weight":
            a = np.ascontiguousarray(a.transpose(*range(2, a.ndim), 1, 0))
        node = params.setdefault(path[0], {})
        if len(path) == 2:
            node = node.setdefault(path[1], {})
        node["w" if kind == "weight" else "b"] = a
    return dict(model.meta), params


def new_denoiser(arch: str, nf: int = 48, base_width: int = 11, top_width: int = 3,
                 dims: int = 2, seed: int = 0) -> nn.Module:
    """An untrained denoiser for an arch name (``unet-3d`` is the 3D
    ``unet``), initialised at the JAX package's scales from a CPU generator
    seeded with ``seed``; in eval mode, on the CPU, meta in ``.meta``."""
    kind = "unet" if arch == "unet-3d" else arch
    meta = {"arch": kind, "nf": nf, "base_width": base_width, "top_width": top_width,
            "dims": dims}
    model = init_denoiser(meta, torch.Generator().manual_seed(seed))
    model.meta = meta
    return model.eval()


def save_denoiser(path: str, meta: Dict, model: nn.Module) -> None:
    """Write a denoiser checkpoint (.npz: meta and the parameter tree in the
    JAX package's layout)."""
    save_checkpoint(path, meta, params=denoiser_to_numpy(model)[1])


def _pretrained_path(stem: str) -> str:
    path = os.path.join(PRETRAINED_DIR, stem + ".npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained denoiser weights {stem!r} are not bundled ({path})")
    return path


def load_denoiser(name_or_path: str, device="cuda") -> nn.Module:
    """Load a denoiser by pretrained alias or ``.npz`` checkpoint path, in
    eval mode on ``device``; its meta dict (arch, widths, dims) is
    ``.meta``."""
    from topaz_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if name_or_path in PRETRAINED_DENOISERS:
        try:
            path = _pretrained_path(PRETRAINED_DENOISERS[name_or_path])
        except FileNotFoundError:
            # the repo ships v0.2.1 but not v0.2.2 of the default unet
            if name_or_path != "unet":
                raise
            print("# WARNING: unet v0.2.2 weights unavailable; falling "
                  "back to unet-v0.2.1", file=sys.stderr)
            path = _pretrained_path(PRETRAINED_DENOISERS["unet-v0.2.1"])
    else:
        path = name_or_path
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"denoising model {name_or_path!r} is neither a pretrained alias "
                f"({sorted(PRETRAINED_DENOISERS)}) nor a file")
        if not path.endswith(".npz"):
            raise NotImplementedError(
                f"{path}: reading reference .sav denoisers is not yet ported "
                f"to topaz_tpu_torch (ROADMAP P13); only .npz checkpoints load")
    meta, trees = load_checkpoint(path)
    return denoiser_from_numpy(meta, trees["params"]).to(device)
