"""Closed loop through ``denoise.denoise_image``: whole micrographs held in
host memory from set-up, cycled in a seeded order; each output comes back
to the host and is not written.

Traffic keys: ``cameras``, ``micrograph`` (inputs); ``denoise_image``,
passed as it stands to ``denoise_image(...)`` (patches, padding,
filters); ``warm_passes``, whole cycles before the window;
``check.denoised_sample``, the outputs kept, a seeded sample.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from harness import check as judge, inputs


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.workdir = device, workdir
        self.kept = inputs.Reservoir(int(traffic["check"]["denoised_sample"]),
                                     inputs.host_rng(seed, "denoised-sample"))
        self.options = traffic.get("denoise_image", {})
        self.completed = 0
        self.attempted = 0
        self.pixels = 0

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"unet": self.model.model}

    def setup(self):
        from topaz_tpu_torch.denoise import Denoise, denoise_image

        self._denoise_image = denoise_image
        images = inputs.micrograph_set(self.traffic["cameras"], self.traffic["micrograph"],
                                       self.seed, self.device)
        self.images = [(name, img.cpu().numpy()) for name, img in images]
        del images
        self.model = Denoise(self.config["denoiser"]["model"], device=self.device)
        self.order_rng = inputs.host_rng(self.seed, "cycle-order")
        for _ in range(int(self.traffic["warm_passes"])):
            for _, mic in self.images:
                self._denoise_image(mic, [self.model], **self.options)

    def window(self, seconds: float) -> float:
        t0 = time.perf_counter()
        while True:
            for i in self.order_rng.permutation(len(self.images)):
                name, mic = self.images[i]
                self.attempted += 1
                out = self._denoise_image(mic, [self.model], **self.options)
                self.completed += 1
                self.pixels += out.size
                self.kept.offer(lambda: (name, out))
                elapsed = time.perf_counter() - t0
                if elapsed >= seconds:
                    return elapsed

    def free(self):
        del self.model


def check(driver: Driver, ref: judge.Reference):
    """The sample of outputs against the reference's whole-image denoise of
    the same micrographs."""
    refs, gaps = {}, []
    images = dict(driver.images)
    for name, out in driver.kept.items:
        if name not in refs:
            refs[name] = ref.denoise_whole(images[name])
        gaps.append(judge.denoise_gap(out, refs[name]))
    return {"denoise_gap": judge.worst(gaps),
            "missing": driver.attempted - driver.completed}, {}


def control(ref: judge.Reference, traffic: dict, seed: int, device, workdir: str):
    """The reference's denoise in TF32 judged against its float32 one."""
    images = [x.cpu().numpy() for _, x in
              inputs.micrograph_set(traffic["cameras"], traffic["micrograph"], seed, device)]
    return judge.control_denoise(ref, images)
