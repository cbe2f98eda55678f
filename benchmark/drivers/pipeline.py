"""Closed loop through ``MicrographPipeline.process``: whole passes of the
mix's micrographs (MRC files written in set-up, each repeated to its
camera's ``count``, in a seeded order a pass), back to back until the
window has run.

Traffic keys: ``cameras``, ``micrograph`` (inputs); ``denoise`` (the
U-Net arm, with the configuration's denoiser); ``pipeline`` and
``process``, passed as they stand to ``MicrographPipeline(...)`` and to
``process(...)``, beside the configuration's path settings;
``warm_passes``, whole passes before the window; ``check.denoised_sample``,
the denoised images kept, a seeded sample.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from harness import check as judge, inputs


def _copy(a) -> np.ndarray:
    return np.array(a, copy=True)


def _pass_list(traffic: dict, paths_by_camera: Dict[str, List[str]]) -> List[str]:
    """Every camera's files, each repeated in turn to the camera's count."""
    out = []
    for cam in traffic["cameras"]:
        files = paths_by_camera[cam["name"]]
        out += [files[i % len(files)] for i in range(int(cam["count"]))]
    return out


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.workdir = device, workdir
        self.answers: list = []      # (path, scores, coords (x, y)) of every yield
        self.denoised = inputs.Reservoir(int(traffic["check"]["denoised_sample"]),
                                         inputs.host_rng(seed, "denoised-sample"))
        self.completed = 0
        self.attempted = 0

    def modules(self) -> Dict[str, torch.nn.Module]:
        out = {"picker": self.pipe.picker}
        if self.pipe.denoiser is not None:
            out["unet"] = self.pipe.denoiser
        return out

    def setup(self):
        from topaz_tpu_torch.pipeline import MicrographPipeline

        cfg, path = self.config, self.config["path"]
        t0 = time.perf_counter()
        self.paths_by_camera = inputs.write_inputs(self.traffic, self.seed, self.device,
                                                   self.workdir)
        files = [p for ps in self.paths_by_camera.values() for p in ps]
        print(f"set-up: {len(files)} files, {sum(map(os.path.getsize, files))} bytes made, "
              f"written and flushed in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        self.pass_paths = _pass_list(self.traffic, self.paths_by_camera)
        self.pipe = MicrographPipeline(
            model=cfg["picker"]["model"],
            denoise_model=cfg["denoiser"]["model"] if self.traffic.get("denoise") else None,
            scale=path["scale"], radius=path["radius"], threshold=path["threshold"],
            bucket_step=path["bucket_step"], device=self.device,
            **self.traffic.get("pipeline", {}))
        self.order_rng = inputs.host_rng(self.seed, "pass-order")
        # the first pass builds the kernels and meets every bucket shape;
        # the next let the loaders, the allocator and the page cache settle
        for _ in range(int(self.traffic["warm_passes"])):
            for _ in self._pass(keep=False):
                pass

    def _pass(self, keep: bool):
        order = self.order_rng.permutation(len(self.pass_paths))
        for res in self.pipe.process([self.pass_paths[i] for i in order],
                                     **self.traffic.get("process", {})):
            if keep:
                path, scores, coords = res[:3]
                self.answers.append((path, _copy(scores), _copy(coords)))
                if len(res) > 3:
                    self.denoised.offer(lambda: (path, _copy(res[3])))
            yield res

    def window(self, seconds: float) -> float:
        """Whole passes until ``seconds`` have gone; returns the seconds
        from the window's start to the last pass's last answer."""
        t0 = time.perf_counter()
        while True:
            self.attempted += len(self.pass_paths)
            for _ in self._pass(keep=True):
                self.completed += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                return elapsed

    def free(self):
        del self.pipe


def check(driver: Driver, ref: judge.Reference):
    """Every answer of the window against the reference's score maps of its
    file (equal answers judged once), and the sample of denoised images;
    the facts are the reference's EM evaluations a file."""
    r, t = ref.cfg["path"]["radius"], ref.cfg["path"]["threshold"]
    denoise = bool(driver.traffic.get("denoise"))
    files = sorted({p for p, _, _ in driver.answers})
    maps, dens = ref.picks(files, denoise)
    judged = {}
    for p, s, c in driver.answers:
        key = (p, np.asarray(s).tobytes(), np.asarray(c).tobytes())
        if key not in judged:
            judged[key] = judge.answer_gap(maps[p][0], s, c, r, t)
    readings = {"pick_gap": judge.worst(judged.values()),
                "missing": driver.attempted - driver.completed}
    if denoise:
        readings["denoise_gap"] = judge.worst(
            [judge.denoise_gap(d, dens[p]) for p, d in driver.denoised.items])
    return readings, {"em_evaluations": {p: maps[p][1] for p in files}}


def control(ref: judge.Reference, traffic: dict, seed: int, device, workdir: str):
    """The reference in TF32 in the program's place on the cell's inputs:
    its greedy picks and denoised images judged as the program's are."""
    by_cam = inputs.write_inputs(traffic, seed, device, workdir)
    files = [f for fs in by_cam.values() for f in fs]
    return judge.control_picks(ref, files, bool(traffic.get("denoise")))
