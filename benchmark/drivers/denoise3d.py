"""Closed loop through ``Denoise3D.denoise``: whole tomograms held in host
memory from set-up, cycled in a seeded order, each denoised in patches (the
call ``denoise_tomogram`` and the ``denoise3d`` command make); each output
comes back to the host and is not written.

The configuration's ``denoiser3d`` gives the model (its meta and layer
list) and ``path`` the patching. Its weights are drawn from the seed at the
published layer shapes and written in set-up as a ``.npz`` in the JAX
layout (kernels DHWIO), which the program loads with ``load_denoiser`` and
the reference reads itself.

Traffic keys: ``shape`` and ``volumes`` (the distinct tomograms),
``tomogram`` (what they hold), ``warm_volumes`` (denoised before the
window), ``check.denoised_sample`` (the outputs kept, a seeded sample).
"""

from __future__ import annotations

import json
import math
import sys
import time
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from harness import check as judge, inputs
from reference import unet3d

# leaky ReLU slope of the network, for the weights' scale
LEAK = 0.1


def write_weights(path: str, model: dict, seed: int) -> None:
    """A checkpoint of ``model`` (the configuration's ``denoiser3d``) with
    weights drawn from ``seed``: each kernel uniform in +-sqrt(6 / (fan_in
    (1 + 0.1^2))), the scale that keeps a leaky-ReLU network's activations
    at the input's size through every layer, as training leaves them; each
    bias uniform in +-1/sqrt(fan_in). Kernels are DHWIO under
    ``params:<module>.<index>.w``; the meta is the program's checkpoint
    meta."""
    rng = inputs.host_rng(seed, "unet3d-weights")
    arrays = {}
    for layer in model["layers"]:
        k, cin, cout = layer["k"], layer["cin"], layer["cout"]
        fan_in = cin * k ** 3
        bound = math.sqrt(6.0 / (fan_in * (1 + LEAK ** 2)))
        arrays[f"params:{layer['name']}.w"] = rng.uniform(
            -bound, bound, size=(k, k, k, cin, cout)).astype(np.float32)
        arrays[f"params:{layer['name']}.b"] = rng.uniform(
            -1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in), size=(cout,)).astype(np.float32)
    meta = {key: model[key] for key in ("arch", "dims", "nf", "base_width", "top_width")}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def tomogram(shape, p: dict, gen: torch.Generator, device) -> torch.Tensor:
    """One (D, H, W) float32 tomogram on ``device``: dense solid spheres
    (macromolecules at the traffic's volume fraction, uniformly placed)
    over white noise and 1/f noise."""
    shape = tuple(int(n) for n in shape)
    r = float(p["particle_radius_px"])
    voxels = math.prod(shape)
    n = int(round(p["volume_fraction"] * voxels / (4.0 / 3.0 * math.pi * r ** 3)))
    where = torch.randint(0, voxels, (n,), generator=gen, device=device)
    delta = torch.zeros(voxels, device=device)
    delta.index_put_((where,), torch.ones(n, device=device), accumulate=True)
    delta = delta.reshape(shape)
    # a sphere centred on voxel (0, 0, 0) of the periodic grid
    d2 = 0
    for axis, m in enumerate(shape):
        c = torch.arange(m, device=device)
        c = torch.minimum(c, m - c).float() ** 2
        d2 = d2 + c.reshape([-1 if a == axis else 1 for a in range(3)])
    sphere = (d2 <= r * r).float()
    signal = torch.fft.irfftn(torch.fft.rfftn(delta) * torch.fft.rfftn(sphere), s=shape)
    del delta, sphere
    f2 = 0
    for axis, m in enumerate(shape):
        f = (torch.fft.rfftfreq(m, device=device) if axis == 2
             else torch.fft.fftfreq(m, device=device)) ** 2
        f2 = f2 + f.reshape([-1 if a == axis else 1 for a in range(3)])
    pink = torch.fft.irfftn(torch.fft.rfftn(torch.randn(shape, generator=gen, device=device))
                            / torch.sqrt(torch.clamp(torch.sqrt(f2) / 0.002, min=1.0)), s=shape)
    pink = pink / pink.std()
    white = torch.randn(shape, generator=gen, device=device)
    return (p["signal"] * signal + p["pink"] * pink + p["white"] * white).float()


def volumes(traffic: dict, seed: int, device) -> List[np.ndarray]:
    """The traffic's distinct tomograms, made on ``device``, in host memory."""
    gen = inputs.device_generator(seed, "tomograms", device)
    return [tomogram(traffic["shape"], traffic["tomogram"], gen, device).cpu().numpy()
            for _ in range(int(traffic["volumes"]))]


def program_counters() -> Dict[str, int]:
    """``Denoise3D``'s module counters of its work (patches, voxels through
    the network and out, volumes by route), where the program keeps them."""
    from topaz_tpu_torch import denoise

    names = ("patches_denoised", "network_voxels", "output_voxels", "resident_volumes",
             "streaming_volumes")
    return {n: getattr(denoise, n) for n in names if hasattr(denoise, n)}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.workdir = device, workdir
        self.kept = inputs.Reservoir(int(traffic["check"]["denoised_sample"]),
                                     inputs.host_rng(seed, "denoised-sample"))
        path = config["path"]
        self.options = {"patch_size": path["patch_size"], "padding": path["padding"],
                        "batch_size": path["batch_size"], "verbose": False}
        self.weights = f"{workdir}/unet3d.npz"
        self.routes: Counter = Counter()
        self.completed = 0
        self.attempted = 0
        self.pixels = 0

    def modules(self) -> Dict[str, torch.nn.Module]:
        # the program's own denoise3d/* spans are read, no hook of ours
        return {}

    def setup(self):
        from topaz_tpu_torch.denoise import Denoise3D

        write_weights(self.weights, self.config["denoiser3d"], self.seed)
        self.volumes = volumes(self.traffic, self.seed, self.device)
        self.model = Denoise3D(self.weights, device=self.device)
        self.order_rng = inputs.host_rng(self.seed, "cycle-order")
        for i in range(int(self.traffic["warm_volumes"])):
            self.model.denoise(self.volumes[i % len(self.volumes)], **self.options)

    def window(self, seconds: float) -> float:
        before = program_counters()
        t0 = time.perf_counter()
        while True:
            for i in self.order_rng.permutation(len(self.volumes)):
                self.attempted += 1
                out = self.model.denoise(self.volumes[i], **self.options)
                self.completed += 1
                self.pixels += out.size
                self.routes[self.model.last_route] += 1
                self.kept.offer(lambda: (int(i), out))
                elapsed = time.perf_counter() - t0
                if elapsed >= seconds:
                    counted = {k: v - before[k] for k, v in program_counters().items()}
                    print(f"denoise3d routes in the window: {dict(self.routes)}; the program's "
                          f"counters: {counted}", file=sys.stderr)
                    return elapsed

    def free(self):
        del self.model


def _reference(config: dict, weights: str, volume: np.ndarray, device, tf32: bool):
    path = config["path"]
    w = unet3d.load_npz(weights, device)
    return unet3d.denoise_patches(torch.from_numpy(volume).to(device), w, path["patch_size"],
                                  path["padding"], tf32=tf32)


def check(driver: Driver, ref: judge.Reference):
    """The sampled outputs against the reference's patch loop over the
    same tomograms, recomputed on the card."""
    gaps = []
    for i, out in driver.kept.items:
        want = _reference(driver.config, driver.weights, driver.volumes[i], ref.device, ref.tf32)
        gaps.append(judge.denoise_gap(out, want))
        del want
    return {"denoise_gap": judge.worst(gaps),
            "missing": driver.attempted - driver.completed}, {}


def control(ref: judge.Reference, traffic: dict, seed: int, device, workdir: str):
    """The reference's patch loop in TF32 judged against its float32 one, on
    a seeded one of the cell's tomograms with the cell's weights."""
    weights = f"{workdir}/unet3d.npz"
    write_weights(weights, ref.cfg["denoiser3d"], seed)
    vols = volumes(traffic, seed, device)
    x = vols[int(inputs.host_rng(seed, "control-volume").integers(0, len(vols)))]
    want = _reference(ref.cfg, weights, x, device, False)
    low = _reference(ref.cfg, weights, x, device, True)
    return {"denoise_gap": judge.denoise_gap(low.cpu().numpy(), want)}
