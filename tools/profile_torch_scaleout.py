#!/usr/bin/env python3
"""``-d -2`` on several NVIDIA GPUs against one (the PyTorch/CUDA port,
topaz_tpu_torch): whether the shards of a mesh run together.

    python3 tools/profile_torch_scaleout.py [--files 16] [--dispatch serial]

Over every visible CUDA device (``resolve_devices(-2)``), each against
``cuda:0`` alone, in one process:

1. the batched pipeline: ``--files`` synthetic MRCs of 4096 x 4096 (those
   of chip_smoke.py, seed 0) through ``MicrographPipeline(model=
   "resnet8_u32", denoise_model="unet", scale=8, radius=14, threshold=-6,
   num_workers=4)`` with device prep at batch 8, on one device and over
   ``hybrid_mesh_for(devices, 8)``, and on one device at batch 2 (one
   shard's work at 4 devices); a cold pass, then the warm pass timed
   (wall clock, micrographs a second), and the picks held together;
2. whole-image denoising of one 4096 x 4096 micrograph with ``unet``:
   ``Denoise("unet")`` against ``Denoise("unet", devices=devices)`` (the
   halo route over the devices), the median of 5 warm calls each, host
   clock around work that ends in a synchronisation;
3. the data-parallel train step of ``resnet8_u32`` on 256 crops of 71^2
   (``make_train_step`` over ``data_mesh_for(devices, 256)``) against one
   device: the median of 10 warm steps.

``--dispatch serial`` issues a mesh's shards one after another from the
calling thread instead of from a thread each (``parallel/mesh.run_each``),
to tell the cost of the threads from that of the work. Prints the cards'
names and power limits first and one JSON line last. Needs at least one
CUDA device; with one, the mesh rows are skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import Future

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed(fn, calls: int):
    """Median seconds of ``calls`` calls of ``fn``, each ending in a
    synchronisation of every device, after one untimed call."""
    import torch

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    fn()
    sync()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


class _Serial:
    """An executor that runs each call at once, on the calling thread."""

    def submit(self, fn, *args):
        future = Future()
        try:
            future.set_result(fn(*args))
        except BaseException as e:
            future.set_exception(e)
        return future


def pipeline_rows(workdir: str, devices, n_files: int):
    import numpy as np

    from chip_smoke import picks_of, run_pipeline_pass, write_micrographs, compare_picks
    from topaz_tpu_torch.parallel.devices import hybrid_mesh_for
    from topaz_tpu_torch.pipeline import MicrographPipeline

    paths = write_micrographs(workdir, np.random.default_rng(0), [(4096, 4096)], n_files)
    kw = dict(model="resnet8_u32", denoise_model="unet", scale=8, radius=14, threshold=-6.0,
              num_workers=4, host_downsample=False)
    out, picks = {}, {}
    for tag, mesh, batch in (("one", None, 8), ("one_batch2", None, 2),
                             ("mesh", hybrid_mesh_for(devices, 8), 8)):
        if tag == "mesh" and mesh is None:
            continue
        pipe = MicrographPipeline(mesh=mesh, device=devices[0], **kw)
        run_pipeline_pass(pipe, paths, f"{tag}, cold", batch_size=batch)
        t0 = time.perf_counter()
        picks[tag] = run_pipeline_pass(pipe, paths, f"{tag}, warm", batch_size=batch)
        dt = time.perf_counter() - t0
        out[tag] = {"mesh": None if mesh is None else dict(mesh.shape), "batch": batch,
                    "s": dt, "micrographs_per_s": len(paths) / dt}
    if "mesh" in picks:
        out["picks_max_diff"] = max(
            compare_picks(picks_of(*picks["mesh"][p][:2]), picks_of(*picks["one"][p][:2]),
                          tie=1e-3, relative=True, labels=("mesh", "one"))
            for p in paths)
    return out


def denoise_rows(devices):
    import numpy as np
    import torch

    from topaz_tpu_torch.denoise import Denoise
    from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph

    x, _ = make_ctf_micrograph(np.random.default_rng(0), size=4096, n_particles=60)
    xt = torch.from_numpy(x).to(devices[0])
    out = {}
    for tag, devs in (("one", None), ("mesh", devices)):
        if tag == "mesh" and len(devices) < 2:
            continue
        den = Denoise("unet", device=devices[0], devices=devs)
        out[tag] = {"devices": 1 if devs is None else len(devs),
                    "ms": 1e3 * _timed(lambda: den.denoise(xt, patch_size=0), 5)}
        del den
        torch.cuda.empty_cache()
    return out


def train_rows(devices):
    import numpy as np
    import torch

    from topaz_tpu_torch.models.factory import load_picker
    from topaz_tpu_torch.parallel.devices import data_mesh_for
    from topaz_tpu_torch.train.methods import make_loss_fn
    from topaz_tpu_torch.train.trainer import init_train_state, make_train_step

    rng = np.random.default_rng(0)
    crops = torch.from_numpy(rng.normal(size=(256, 71, 71)).astype(np.float32)).to(devices[0])
    labels = torch.from_numpy((np.arange(256) % 4 == 0).astype(np.float32)).to(devices[0])
    out = {}
    for tag, mesh in (("one", None), ("mesh", data_mesh_for(devices, 256))):
        if tag == "mesh" and mesh is None:
            continue
        state = init_train_state(load_picker("resnet8_u32", device=devices[0]), 0.05)
        step = make_train_step(make_loss_fn("GE-binomial", 0.05)[0], mesh=mesh)
        out[tag] = {"devices": 1 if mesh is None else mesh.shape["data"],
                    "ms": 1e3 * _timed(lambda: step(state, crops, labels), 10)}
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--files", type=int, default=16,
                        help="synthetic 4096^2 micrographs through the pipeline (default 16)")
    parser.add_argument("--dispatch", choices=("threads", "serial"), default="threads",
                        help="issue a mesh's shards from a thread each (the port's way, "
                             "default) or one after another")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    from topaz_tpu_torch.parallel import mesh as pmesh
    from topaz_tpu_torch.parallel.devices import resolve_devices

    if args.dispatch == "serial":
        pmesh._POOL = _Serial()

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(cards.strip())
    devices = resolve_devices(-2)
    print(f"# {len(devices)} devices: {[str(d) for d in devices]}")
    result = {"cards": cards.strip().splitlines(), "devices": len(devices),
              "dispatch": args.dispatch}
    with tempfile.TemporaryDirectory() as workdir:
        result["pipeline"] = pipeline_rows(workdir, devices, args.files)
    print(f"# pipeline: {result['pipeline']}", flush=True)
    result["denoise"] = denoise_rows(devices)
    print(f"# denoise: {result['denoise']}", flush=True)
    result["train_step"] = train_rows(devices)
    print(f"# train step: {result['train_step']}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
