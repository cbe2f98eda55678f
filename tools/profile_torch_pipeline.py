#!/usr/bin/env python3
"""Where the batched micrograph pipeline spends its time on one NVIDIA GPU
(the PyTorch/CUDA port, topaz_tpu_torch).

    python3 tools/profile_torch_pipeline.py [--out TRACE_DIR]

On the 24 synthetic MRCs of chip_smoke.py (seed 0, 8 each of 4096 x 4096,
5760 x 4092 and 3838 x 3710), with ``MicrographPipeline(model="resnet8_u32",
denoise_model="unet", scale=8, radius=14, threshold=-6, num_workers=2)`` at
batch 8, host prep and device prep:

1. the loaders alone: the time the two loader threads take to read (and,
   with host prep, downsample) all 24 files, with no device work;
2. the device alone: each bucket's batch function on batches already on the
   card, host clock around work that ends in a synchronisation, and the
   part of it in the GMM fit, in scoring + NMS and in the denoise arm; the
   GMM fit twice, its EM through the kernel (csrc/gmm_em.cu, one launch a
   fit, as the pipeline runs it) and through the plain version
   (ops/gmm._gmm_fit_plain, eager steps with a host check each), so the
   two stand side by side from one run;
3. one warm pass of ``process`` under ``torch.profiler``: wall time, the
   device's busy share of it (the union of its kernel and copy intervals),
   and device time by operator. A Chrome trace
   goes to ``--out`` when it is given.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sync_clock(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def loaders_alone(pipe, paths, batch_size):
    """Seconds the loader threads take for every file, no device work. With
    device prep they read into the pipeline's frame pool, as ``process``
    does, and each batch's frames go back once it is loaded (the first call
    allocates the frames)."""
    from topaz_tpu_torch.pipeline import _image_shape
    from topaz_tpu_torch.utils.batching import window_batches
    from topaz_tpu_torch.transfer import in_flight

    items = [(p, _image_shape(p)) for p in paths]
    frames = pipe._frames.lease(in_flight(batch_size, 2))
    t0 = time.perf_counter()
    for _, _, loaded in window_batches(
            items, lambda it: pipe._load_one(it[0], pipe._bucket_for(pipe._ds_shape(it[1])),
                                             frames=frames),
            batch_size, batch_size * 3, num_workers=pipe.num_workers):
        for x in loaded:
            frames.give(x)  # host prep's arrays are not the pool's: left alone
    frames.close()
    return time.perf_counter() - t0


@contextlib.contextmanager
def plain_em():
    """Within it, gmm_fit runs its EM through the plain version on the card
    too (for timing the kernel against it; the port never does this)."""
    from topaz_tpu_torch.ops import gmm

    kernel = gmm._gmm_fit_kernel
    gmm._gmm_fit_kernel = gmm._gmm_fit_plain
    try:
        yield
    finally:
        gmm._gmm_fit_kernel = kernel


def device_alone(pipe, paths, batch_size):
    """Per bucket: seconds of the batch function on a batch already on the
    card, and of its GMM fit (EM through the kernel, and through the plain
    version), its scoring + NMS and its denoise arm."""
    import numpy as np
    import torch

    from topaz_tpu_torch.ops.gmm import norm_fit
    from topaz_tpu_torch.ops.nms import nms_topk_batched
    from topaz_tpu_torch.pipeline import _image_shape
    from topaz_tpu_torch.utils.batching import valid_mask

    by_bucket = {}
    for p in paths:
        ds = pipe._ds_shape(_image_shape(p))
        by_bucket.setdefault(pipe._bucket_for(ds), []).append((p, ds))
    rows = []
    for bucket, items in by_bucket.items():
        items = items[:batch_size]
        arr = np.stack([pipe._load_one(p, bucket) for p, _ in items])
        x = torch.from_numpy(arr).cuda()
        valid = torch.tensor([ds for _, ds in items]).cuda()
        fn = pipe._fn_for(bucket)
        fn(x, valid)  # warm
        _, t_all = _sync_clock(lambda: fn(x, valid))
        with torch.inference_mode():
            B = x.shape[0]
            maskf = valid_mask(bucket, valid).float()
            (mu, std, *_), t_gmm = _sync_clock(
                lambda: norm_fit(x.reshape(B, -1), w=maskf.reshape(B, -1)))
            with plain_em():
                _, t_gmm_plain = _sync_clock(
                    lambda: norm_fit(x.reshape(B, -1), w=maskf.reshape(B, -1)))
            norms = (x - mu[:, None, None]) / std[:, None, None] * maskf
            scores, t_score = _sync_clock(lambda: pipe.picker(norms))
            _, t_nms = _sync_clock(lambda: nms_topk_batched(
                scores, pipe.radius, pipe.threshold, 4096))
            _, t_den = _sync_clock(lambda: pipe.denoiser(norms[:, None]))
        rows.append((bucket, len(items), t_all, t_gmm, t_gmm_plain, t_score, t_nms, t_den))
    return rows


def profiled_pass(pipe, paths, batch_size, out_dir, tag):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in pipe.process(paths, batch_size=batch_size):
        pass  # warm
    torch.cuda.synchronize()
    import chip_smoke

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("pipeline_pass"):
            t0 = time.perf_counter()
            n = sum(1 for _ in pipe.process(paths, batch_size=batch_size))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # the union of kernel and copy intervals, without the device-side
    # copies of the stage spans, which cover whole batches
    busy_us = chip_smoke.device_busy(prof, "pipeline_pass")[0]
    by_op = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if t > 0 and e.device_type != torch.autograd.DeviceType.CUDA:
            by_op[e.key] = by_op.get(e.key, 0) + t
    print(f"# {tag}, profiled warm pass: {n} micrographs, wall {wall_us / 1e3:.3f} ms "
          f"({n / wall_us * 1e6:.3f} micrographs/s under the profiler), device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.4f} of wall, idle "
          f"{1 - busy_us / wall_us:.4f}), {len(kernels)} kernels")
    total = sum(by_op.values()) or 1
    for op, t in sorted(by_op.items(), key=lambda kv: -kv[1])[:12]:
        print(f"#   {op:44s} {t / 1e3:10.3f} ms  {t / total:.3f}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_pipeline_{tag}.json"))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="directory for the Chrome traces (default: none written)")
    args = parser.parse_args()

    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_pipeline: no CUDA device available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"# card: {card}")

    import chip_smoke
    from topaz_tpu_torch.pipeline import MicrographPipeline

    batch = chip_smoke.BATCH
    with tempfile.TemporaryDirectory() as work:
        paths = chip_smoke.write_micrographs(work, np.random.default_rng(chip_smoke.SEED),
                                             chip_smoke.GEOMETRIES,
                                             chip_smoke.FILES_PER_GEOMETRY)
        for host in (True, False):
            tag = "host prep" if host else "device prep"
            pipe = MicrographPipeline(model="resnet8_u32", denoise_model="unet", scale=8,
                                      radius=chip_smoke.RADIUS, threshold=chip_smoke.THRESHOLD,
                                      host_downsample=host, num_workers=2)
            t = loaders_alone(pipe, paths, batch)
            print(f"# {tag}: loaders alone, {len(paths)} files in {t:.3f} s "
                  f"({len(paths) / t:.3f} files/s)")
            if host:
                for bucket, b, t_all, t_gmm, t_plain, t_score, t_nms, t_den in device_alone(
                        pipe, paths, batch):
                    print(f"# device alone, bucket {bucket} x {b}: batch function "
                          f"{t_all * 1e3:.3f} ms; GMM {t_gmm * 1e3:.3f} ms ({t_gmm / t_all:.4f} "
                          f"of the batch; its EM through the plain version instead "
                          f"{t_plain * 1e3:.3f} ms), scoring {t_score * 1e3:.3f} ms, NMS "
                          f"{t_nms * 1e3:.3f} ms, U-Net {t_den * 1e3:.3f} ms")
            profiled_pass(pipe, paths, batch, args.out, tag.replace(" ", "_"))


if __name__ == "__main__":
    main()
