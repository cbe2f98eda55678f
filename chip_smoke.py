#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (topaz_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before a result is printed:

1. Require a CUDA device; print the card's name and power limit.
2. Build every CUDA kernel of the port from csrc/ (nvcc, sm_90a).
3. Hold each kernel bit-equal against its plain PyTorch version on the card
   (disk_max: f32 and int32; (512, 512), (3, 300, 200), (1, 4096, 4096);
   r = 0, 3, 7, 14, 60, 96, 97, 100, either side of the largest radius
   whose window fits in shared memory), and time kernel and plain version at the main path's
   shape with CUDA events (device time from a CUDA graph of many calls, and
   the eager time a call), beside the least time the card could take.
4. Drive the main path through the CLI a user calls: a 4096^2 synthetic
   micrograph through ``preprocess -s 8`` and
   ``extract -m resnet8_u32 -r 14 -t -6`` on the card (launch counts read
   from that run), then again warm, then on the CPU. Picks must be
   non-empty and identical between card and CPU (a differing pick only where
   the two scores that decided it lie within 1e-5), matched scores within
   1e-3 and the normalized micrographs within 1e-3 (f32 FFT, EM and
   convolution sum orders differ between cuFFT/cuDNN and the CPU).
5. Print the kernels line, the card line, and last the result line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
RADIUS = 14
THRESHOLD = -6.0
SIZE = 4096
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time a call as called from Python: CUDA events around ``iters``
    eager calls. At small sizes this is the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device time a call: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so the host's launch
    cost is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def disk_max_bound(shape, r: int, itemsize: int):
    """Least time for one disk max-filter: each input read once and each
    output written once, against the chord decomposition's max operations
    (2 max_w horizontal and 2r vertical maxes a pixel) at the f32 rate."""
    from topaz_tpu_torch.ops.nms import _chords_2d

    pixels = math.prod(shape)
    t_bytes = 2 * pixels * itemsize / HBM_BYTES_PER_S
    t_ops = pixels * (2 * max(_chords_2d(r)) + 2 * r) / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_disk_max():
    """Kernel against plain version, bit-equal; returns the max abs error
    and, at the main path's shape, the times of kernel and plain version
    (device time from a CUDA graph, and eager time a call) and the bound."""
    import torch

    from topaz_tpu_torch.ops import disk_max as dm
    from topaz_tpu_torch.ops.nms import INT_NEG, NEG, disk_max as plain

    g = torch.Generator(device="cuda").manual_seed(SEED)
    err = 0.0
    for shape in [(512, 512), (3, 300, 200), (1, 4096, 4096)]:
        for r in (0, 3, 7, 14, 60, 96, 97, 100):
            for dtype, init in ((torch.float32, NEG), (torch.int32, INT_NEG)):
                if dtype == torch.float32:
                    x = torch.randn(shape, device="cuda", generator=g)
                else:
                    x = torch.randint(-999, 999, shape, device="cuda",
                                      generator=g, dtype=torch.int32)
                got = dm.disk_max(x, r, init)
                torch.cuda.synchronize()
                want = plain(x, r, init)
                torch.cuda.synchronize()
                diff = (got.double() - want.double()).abs().max().item()
                err = max(err, diff)
                if not torch.equal(got, want):
                    fail(f"disk_max {dtype} {shape} r={r}: kernel differs from "
                         f"plain version (max abs diff {diff})")
                print(f"# disk_max {str(dtype):13s} {str(shape):17s} r={r:3d}: bit-equal")
    side = SIZE // 8
    x = torch.randn((side, side), device="cuda", generator=g)
    times = {
        "ms": graph_ms(lambda: dm.disk_max(x, RADIUS, NEG), 200),
        "plain_ms": graph_ms(lambda: plain(x, RADIUS, NEG), 20),
        "eager_ms": cuda_ms(lambda: dm.disk_max(x, RADIUS, NEG), 200),
        "plain_eager_ms": cuda_ms(lambda: plain(x, RADIUS, NEG), 20),
    }
    bound_ms, bound_by = disk_max_bound(x.shape, RADIUS, 4)
    print(f"# disk_max f32 {side}x{side} r={RADIUS}: device time a call (CUDA graph) "
          f"kernel {times['ms']:.5f} ms, plain {times['plain_ms']:.5f} ms; eager a call "
          f"kernel {times['eager_ms']:.5f} ms, plain {times['plain_eager_ms']:.5f} ms; "
          f"bound {bound_ms:.5f} ms ({bound_by})")
    return err, times, bound_ms, bound_by


def read_picks(path):
    picks = {}
    with open(path) as f:
        next(f)
        for line in f:
            _, x, y, s = line.rstrip("\n").split("\t")
            picks[(int(x), int(y))] = float(s)
    return picks


def compare_picks(card, cpu):
    """Differing picks are allowed only where the two deciding scores lie
    within 1e-5: the pick of one run against a pick of the other run inside
    the NMS radius, or against the threshold."""
    for mine, other, label in ((card, cpu, "card"), (cpu, card, "cpu")):
        for p in sorted(set(mine) - set(other)):
            near = [q for q in other
                    if (q[0] - p[0]) ** 2 + (q[1] - p[1]) ** 2 <= RADIUS ** 2]
            gap = min([abs(mine[p] - THRESHOLD)]
                      + [abs(mine[p] - other[q]) for q in near])
            print(f"# pick {p} only in the {label} run: score {mine[p]}, "
                  f"closest deciding score gap {gap}")
            if gap > 1e-5:
                fail(f"pick {p} of the {label} run is not a near-tie (gap {gap})")
    common = set(card) & set(cpu)
    return max((abs(card[p] - cpu[p]) for p in common), default=0.0)


def run_slice(workdir: str):
    """preprocess -> extract through the CLI on the card (cold, then warm)
    and on the CPU; returns the disk_max launches of the cold card run."""
    import numpy as np
    import torch

    from topaz_tpu_torch.cli.main import main as cli
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.ops import disk_max as dm
    from topaz_tpu_torch.ops.nms import _greedy_rounds, disk_max as plain
    from topaz_tpu_torch.extract import score_images
    from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph

    x, _ = make_ctf_micrograph(np.random.default_rng(SEED), size=SIZE, n_particles=60)
    raw = os.path.join(workdir, "raw.mrc")
    mrc.write(raw, x)

    def stages(device: str, tag: str):
        proc = os.path.join(workdir, f"proc_{tag}")
        picks = os.path.join(workdir, f"picks_{tag}.txt")
        t0 = time.perf_counter()
        cli(["preprocess", "-s", "8", "-o", proc, "-d", device, raw])
        t1 = time.perf_counter()
        cli(["extract", "-m", "resnet8_u32", "-r", str(RADIUS), "-t", str(THRESHOLD),
             "-o", picks, "-d", device, os.path.join(proc, "raw.mrc")])
        if device != "cpu":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"# {tag}: preprocess {t1 - t0:.3f} s, extract {t2 - t1:.3f} s")
        return os.path.join(proc, "raw.mrc"), picks

    dm.launches = 0
    proc_card, picks_card = stages("0", "card_cold")
    launches = dm.launches
    stages("0", "card_warm")
    proc_cpu, picks_cpu = stages("cpu", "cpu")

    # greedy rounds of this micrograph, counted through the plain filter
    calls = [0]

    def counted(x, init):
        calls[0] += 1
        return plain(x, RADIUS, init)

    _, score = next(score_images("resnet8_u32", [proc_card], device="cuda"))
    _greedy_rounds(score.contiguous(), THRESHOLD, counted)
    rounds = calls[0] // 3
    print(f"# greedy rounds {rounds}, disk_max launches on the card run {launches}")
    if rounds < 1 or launches < 3 * rounds:
        fail(f"disk_max launched {launches} times for {rounds} greedy rounds "
             f"(expected at least {3 * rounds})")

    a, b = mrc.read(proc_card)[0], mrc.read(proc_cpu)[0]
    img_err = float(np.abs(a.astype(np.float64) - b).max())
    print(f"# normalized micrograph {a.shape}: card vs cpu max abs diff {img_err}")
    if a.shape != (SIZE // 8, SIZE // 8) or not np.isfinite(a).all() or img_err > 1e-3:
        fail(f"normalized micrograph: shape {a.shape}, max abs diff {img_err}")

    card, cpu = read_picks(picks_card), read_picks(picks_cpu)
    print(f"# picks: card {len(card)}, cpu {len(cpu)}")
    if not card or not all(math.isfinite(s) for s in card.values()):
        fail("no finite picks on the card run")
    score_err = compare_picks(card, cpu)
    print(f"# matched pick scores: card vs cpu max abs diff {score_err}")
    if score_err > 1e-3:
        fail(f"pick scores differ by {score_err}")
    return launches


def main() -> None:
    sys.path.insert(0, REPO)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device available")
    try:
        import topaz_tpu_torch
        from topaz_tpu_torch._build import build_libraries
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    if os.path.dirname(os.path.abspath(topaz_tpu_torch.__file__)) != os.path.join(
            REPO, "topaz_tpu_torch"):
        fail(f"topaz_tpu_torch was imported from {topaz_tpu_torch.__file__}, "
             f"not from beside this script")
    card = card_line()
    print(f"# card: {card}")

    t = time.perf_counter()
    build_libraries(["disk_max"])
    print(f"# kernels built in {time.perf_counter() - t:.2f} s")

    err, times, bound_ms, bound_by = check_disk_max()
    with tempfile.TemporaryDirectory() as workdir:
        launches = run_slice(workdir)
    if "jax" in sys.modules or "topaz_tpu" in sys.modules:
        fail("JAX or the JAX package was imported")

    kernels = [{
        "name": "disk_max", "route": "cuda",
        "source": "topaz_tpu_torch/csrc/disk_max.cu",
        "replaces": "topaz_tpu/ops/nms_pallas.py:35",
        "launches": launches, "max_abs_err": err,
        "ms": times["ms"], "kernel_ms": times["ms"], "plain_ms": times["plain_ms"],
        "eager_ms": times["eager_ms"], "plain_eager_ms": times["plain_eager_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
