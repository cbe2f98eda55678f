"""Closed loop through ``extract.pick_volume``, the call ``extract --dims
3`` makes: whole tomograms held in host memory from set-up, standardized,
cycled in a seeded order, each scored by the 3D picker in tiles and
suppressed to its picks on the card; the picks come back to the host and
are not written.

The configuration's ``picker3d`` gives the model (its arch, width and layer
list) and ``path`` the tiles, the radius and the threshold's quantile. Its
weights are drawn from the seed at the published layer shapes and written
in set-up as an ``.npz`` in the JAX layout (kernels DHWIO), which the
program loads with ``load_picker`` and the reference reads itself. The
threshold is the quantile of the warm tomogram's score map, fixed for the
run.

Traffic keys: ``shape`` and ``volumes`` (the distinct tomograms, made by
``drivers/denoise3d.tomogram``), ``tomogram`` (what they hold),
``warm_volumes`` (picked before the window), ``check.picked_sample`` (the
answers kept, a seeded sample).
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from harness import check as judge, inputs, spec
from reference import picker3d

tomogram = spec.driver("denoise3d").tomogram


def write_weights(path: str, model: dict, seed: int) -> None:
    """A checkpoint of ``model`` (the configuration's ``picker3d``) with
    weights drawn from ``seed``: each kernel uniform in +-sqrt(6 / fan_in),
    the He scale that keeps a ReLU network's activations at the input's
    size, as training leaves them. Without batch norm each convolution has
    a bias uniform in +-1/sqrt(fan_in). With it (``bn``) a convolution has
    none, and its batch norm a scale uniform in [0.75, 1.25], a bias in
    +-0.1, a running mean in +-0.1 and a running variance in [0.75, 1.25]:
    around the moments that He-scaled weights give a convolution's output
    (mean 0, variance twice the input's mean square, which is 1/2 behind
    the ReLU of a unit-variance layer), so that each layer's output stays
    near unit size, as a trained network's running statistics keep it. Kernels are DHWIO under
    ``params:features.<i>.<name>`` and ``params:classifier``, batch norm's
    scale and bias under ``params:features.<i>.<bn>.`` and its statistics
    under ``state:``; the meta is the program's checkpoint meta."""
    rng = inputs.host_rng(seed, "picker3d-weights")
    arrays = {}
    bn = bool(model["bn"])

    def conv(name, k, cin, cout, bias=True):
        fan_in = cin * k ** 3
        bound = math.sqrt(6.0 / fan_in)
        arrays[f"params:{name}w"] = rng.uniform(
            -bound, bound, size=(k, k, k, cin, cout)).astype(np.float32)
        if bias:
            arrays[f"params:{name}b"] = rng.uniform(
                -1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in), size=(cout,)).astype(np.float32)

    def norm(name, n):
        for tree, key, lo, hi in (("params", "scale", 0.75, 1.25), ("params", "bias", -0.1, 0.1),
                                  ("state", "mean", -0.1, 0.1), ("state", "var", 0.75, 1.25)):
            arrays[f"{tree}:{name}.{key}"] = rng.uniform(lo, hi, size=(n,)).astype(np.float32)

    for i, layer in enumerate(model["layers"]):
        p = f"features.{i}."
        if layer["op"] == "conv":
            conv(p + "conv_", layer["k"], layer["cin"], layer["cout"], bias=not bn)
            if bn:
                norm(p + "bn", layer["cout"])
        else:
            if layer["cin"] != layer["cout"]:
                conv(p + "proj_", 1, layer["cin"], layer["cout"], bias=False)
            conv(p + "conv0_", 3, layer["cin"], layer["hidden"], bias=not bn)
            conv(p + "conv1_", 3, layer["hidden"], layer["cout"], bias=not bn)
            if bn:
                norm(p + "bn0", layer["hidden"])
                norm(p + "bn1", layer["cout"])
    conv("classifier.", 1, model["layers"][-1]["cout"], 1)
    meta = {"arch": model["arch"], "units": model["units"], "bn": bn, "dims": model["dims"]}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def volumes(traffic: dict, seed: int, device) -> List[np.ndarray]:
    """The traffic's distinct tomograms, made on ``device``, each
    standardized (mean 0, population std 1, taken in float64), in host
    memory."""
    gen = inputs.device_generator(seed, "tomograms", device)
    out = []
    for _ in range(int(traffic["volumes"])):
        v = tomogram(traffic["shape"], traffic["tomogram"], gen, device).double()
        v = (v - v.mean()) / v.std(correction=0)
        out.append(v.float().cpu().numpy())
        del v
    return out


def quantile_threshold(score: torch.Tensor, q: float) -> float:
    """The map's ``q`` quantile: its value of rank floor(q (N - 1)) from the
    lowest."""
    flat = score.reshape(-1)
    return float(torch.kthvalue(flat, int(q * (flat.numel() - 1)) + 1).values)


def program_counters() -> Dict[str, int]:
    """``pick_volume``'s module counters of its work: tomograms, tiles,
    voxels through the picker and of the maps, NMS rounds."""
    from topaz_tpu_torch import extract
    from topaz_tpu_torch.models import tiling
    from topaz_tpu_torch.ops import nms

    return {"volumes_picked": extract.volumes_picked, "output_voxels": extract.output_voxels,
            "tiles_scored": tiling.tiles_scored, "network_voxels": tiling.network_voxels,
            "rounds": nms.rounds}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.workdir = device, workdir
        self.kept = inputs.Reservoir(int(traffic["check"]["picked_sample"]),
                                     inputs.host_rng(seed, "picked-sample"))
        path = config["path"]
        self.radius = int(path["radius"])
        self.options = {"patch_size": path["patch_size"], "batch_size": path["batch_size"]}
        self.weights = f"{workdir}/picker3d.npz"
        self.completed = 0
        self.attempted = 0
        self.picks = 0
        self.threshold = None

    def modules(self) -> Dict[str, torch.nn.Module]:
        # the program's own extract3d/* spans are read, no hook of ours
        return {}

    def setup(self):
        # a program without the entry fails here, before any work
        from topaz_tpu_torch.extract import pick_volume
        from topaz_tpu_torch.models.factory import load_picker
        from topaz_tpu_torch.models.tiling import classify_patches_3d
        from topaz_tpu_torch.ops.nms import non_maximum_suppression_3d

        self.pick_volume = pick_volume
        write_weights(self.weights, self.config["picker3d"], self.seed)
        self.volumes = volumes(self.traffic, self.seed, self.device)
        self.model = load_picker(self.weights, device=self.device)
        self.order_rng = inputs.host_rng(self.seed, "cycle-order")
        q = self.config["path"]["threshold_quantile"]
        for i in range(int(self.traffic["warm_volumes"])):
            score = classify_patches_3d(self.model, self.volumes[i % len(self.volumes)],
                                        **self.options)
            if self.threshold is None:
                self.threshold = quantile_threshold(score, q)
            non_maximum_suppression_3d(score, self.radius, threshold=self.threshold,
                                       device=score.device)
            del score

    def window(self, seconds: float) -> float:
        before = program_counters()
        t0 = time.perf_counter()
        while True:
            for i in self.order_rng.permutation(len(self.volumes)):
                self.attempted += 1
                scores, coords = self.pick_volume(self.model, self.volumes[i], self.radius,
                                                  self.threshold, **self.options)
                self.completed += 1
                self.picks += len(scores)
                self.kept.offer(lambda: (int(i), scores, coords))
                elapsed = time.perf_counter() - t0
                if elapsed >= seconds:
                    counted = {k: v - before[k] for k, v in program_counters().items()}
                    print(f"extract3d: {self.completed} tomograms, {self.picks} picks above "
                          f"{self.threshold!r} in the window; the program's counters: {counted}",
                          file=sys.stderr)
                    return elapsed

    def free(self):
        del self.model


def _reference_map(config: dict, weights: str, volume: np.ndarray, device,
                   tf32: bool) -> torch.Tensor:
    return picker3d.picker3d_scores(torch.from_numpy(volume).to(device),
                                    config["picker3d"]["layers"],
                                    picker3d.load_npz(weights, device),
                                    slab=config["path"]["slab"], tf32=tf32)


def check(driver: Driver, ref: judge.Reference):
    """The sampled tomograms' picks against the reference's score map of
    the same tomograms, recomputed on the card, at the threshold the
    reference's own map of the warm tomogram gives by the run's quantile
    rule: no judged number comes from the program."""
    q = driver.config["path"]["threshold_quantile"]
    warm = _reference_map(driver.config, driver.weights, driver.volumes[0], ref.device, ref.tf32)
    t = quantile_threshold(warm, q)
    print(f"extract3d check: threshold {t!r} from the reference's map of the warm tomogram, "
          f"{driver.threshold!r} from the program's", file=sys.stderr)
    gaps = []
    for i, scores, coords in driver.kept.items:
        S = warm if i == 0 else _reference_map(driver.config, driver.weights, driver.volumes[i],
                                               ref.device, ref.tf32)
        gaps.append(picker3d.pick_gap_3d(S, scores, coords, driver.radius, t))
        print(f"extract3d check: tomogram {i}, {len(scores)} picks against the reference's map "
              f"({int((S > t).sum())} voxels above the threshold): pick_gap {gaps[-1]!r}",
              file=sys.stderr)
        del S
    return {"pick_gap": judge.worst(gaps),
            "missing": driver.attempted - driver.completed}, {}


def control(ref: judge.Reference, traffic: dict, seed: int, device, workdir: str):
    """The reference in TF32 in the program's place, on the cell's warm
    tomogram with the cell's weights: its threshold from its own map, its
    greedy picks judged as ``check`` judges the program's, against the
    float32 reference's map at that map's threshold."""
    weights = f"{workdir}/picker3d.npz"
    write_weights(weights, ref.cfg["picker3d"], seed)
    x = volumes(dict(traffic, volumes=1), seed, device)[0]
    path = ref.cfg["path"]
    r = int(path["radius"])
    low = _reference_map(ref.cfg, weights, x, device, True)
    t = quantile_threshold(low, path["threshold_quantile"])
    taken = picker3d.greedy_nms_3d(low, r, t)
    zs, ys, xs = torch.nonzero(taken, as_tuple=True)
    scores = low[zs, ys, xs].cpu().numpy()
    coords = torch.stack([xs, ys, zs], dim=1).cpu().numpy()
    del low, taken
    want = _reference_map(ref.cfg, weights, x, device, False)
    t = quantile_threshold(want, path["threshold_quantile"])
    return {"pick_gap": picker3d.pick_gap_3d(want, scores, coords, r, t)}
