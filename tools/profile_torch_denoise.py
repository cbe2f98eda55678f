#!/usr/bin/env python3
"""Where a 4096^2 denoise spends its time on one NVIDIA GPU (the
PyTorch/CUDA port, topaz_tpu_torch).

    python3 tools/profile_torch_denoise.py [--size 4096] [--out TRACE_DIR]

1. Stage times of one warm ``denoise -m unet -s 0`` as the CLI runs it, on
   the host's clock: read the MRC, load the model, denoise (upload, filter
   pipeline, model, restore, copy back), write the MRC; and the host<->device
   copies of the image alone.
2. ``torch.profiler`` over one warm U-Net forward on the whole image and
   over one warm patched denoise (``-s 1024 -p 500``), f32 with TF32 off as
   the port runs them: device time by operator, and the device's busy share
   of the wall time. Chrome traces go to ``--out`` when it is given.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clock(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profile(name: str, fn, out_dir: str):
    """Run ``fn`` once under the profiler; print device time by operator and
    the busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_op = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if e.key.startswith("aten::") and t > 0:
            by_op[e.key] = by_op.get(e.key, 0) + t
    print(f"# {name}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / wall_us:.3f} of wall), {len(kernels)} kernels")
    total = sum(by_op.values()) or 1
    for op, t in sorted(by_op.items(), key=lambda kv: -kv[1])[:10]:
        print(f"#   {op:40s} {t / 1e3:10.3f} ms  {t / total:.3f}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=4096)
    parser.add_argument("--out", help="directory for the Chrome traces (default: none written)")
    args = parser.parse_args()

    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_denoise: no CUDA device available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"# card: {card}")

    from topaz_tpu_torch.denoise import Denoise, denoise_image
    from topaz_tpu_torch.transfer import as_device_tensor, to_host
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.io.image import load_image, save_image
    from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph

    x, _ = make_ctf_micrograph(np.random.default_rng(0), size=args.size, n_particles=60)
    with tempfile.TemporaryDirectory() as work:
        raw = os.path.join(work, "raw.mrc")
        mrc.write(raw, x)
        model = Denoise("unet-v0.2.1", device="cuda")
        for _ in range(2):  # warm: cuDNN handles, allocator pool
            denoise_image(x, [model], patch_size=-1)
        (image, header, ext), t_read = _clock(lambda: load_image(raw, return_header=True))
        model, t_load = _clock(lambda: Denoise("unet-v0.2.1", device="cuda"))
        y, t_denoise = _clock(lambda: denoise_image(image, [model], patch_size=-1))
        _, t_write = _clock(lambda: save_image(y, os.path.join(work, "out.mrc"), header=header,
                                               extended_header=ext))
        dev, t_up = _clock(lambda: as_device_tensor(image, "cuda"))
        _, t_down = _clock(lambda: to_host(dev))
    print(f"# warm denoise -s 0 at {args.size}^2, host clock: read {t_read:.4f} s, load "
          f"model {t_load:.4f} s, denoise_image {t_denoise:.4f} s (of it upload "
          f"{t_up:.4f} s, copy back {t_down:.4f} s), write {t_write:.4f} s")

    xd = torch.from_numpy(x).cuda()
    with torch.inference_mode():
        xin = ((xd - xd.mean()) / xd.std(correction=0))[None, None]
        model.model(xin)
        _profile(f"unet_forward_{args.size}", lambda: model.model(xin), args.out)
    model.denoise(xd, 1024, 500)
    _profile(f"denoise_patched_{args.size}", lambda: model.denoise(xd, 1024, 500), args.out)


if __name__ == "__main__":
    main()
