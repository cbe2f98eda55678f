#!/usr/bin/env python3
"""Times the disk max-filter kernel (topaz_tpu_torch/csrc/disk_max.cu) on one
NVIDIA GPU, against its plain PyTorch version and, given ``--parent``, the
kernel of another checkout on the same card in the same call.

    python3 tools/profile_torch_disk_max.py [--parent DIR] [--out DIR]

1. Builds this tree's kernel (``topaz_tpu_torch._build``) and prints what
   ``ptxas -v`` says of it (registers, shared memory, spills).
2. On random f32 maps (seed 0) at the shapes of chip_smoke.py's radius sweep
   ((512, 512) at r = 5, 14, 30, 50, 75, 96, 100, at 0, where the launch
   and one block's latency are all there is, and at 85, 86 and 90, where
   the launcher changes kernels at this width) and of the main paths
   ((8, 768, 512) and (8, 512, 512) at r = 14): the plain version's device
   time a call and the bound of ``chip_smoke.disk_max_bound``, in this
   process; then the kernel's device time a call, from a CUDA graph of 200
   calls, in a process of its own that imports the checkout's public
   wrapper ``topaz_tpu_torch.ops.disk_max.disk_max`` and first holds it
   bit-equal to that checkout's plain version. With ``--parent DIR`` (a
   checkout of another commit, e.g. unpacked with ``git archive``) the
   processes take turns: parent, this, this, parent.
3. The row kernel alone at every case: this tree's source built again with
   the launcher's choice pinned to ``disk_max_rows`` (a copy under
   ``topaz_tpu_torch/_build/``), held bit-equal and timed as above, so that
   what the window kernel saves where it runs is measured beside it.

Prints the card's name and power limit first; results also go to
``DIR/disk_max_profile.json`` with ``--out DIR``. ``--times-of DIR`` is the
timing process alone: it prints one JSON list of times, one a case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CASES = ([((512, 512), r) for r in (0, 5, 14, 30, 50, 75, 85, 86, 90, 96, 100)]
         + [((8, 768, 512), 14), ((8, 512, 512), 14)])
CALLS = 200
# the launcher's choice of kernel in csrc/disk_max.cu, pinned by row_kernel_alone
WINDOW_CHOICE = "const bool window = window_bytes<T>(r, reach, warps) <= limit;"


def ptxas_report(src: str) -> str:
    from topaz_tpu_torch._build import NVCC_FLAGS, find_nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = subprocess.run([find_nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o", os.devnull, src],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(out.stderr)
    return out.stderr.strip()


def row_kernel_alone():
    """The f32 entry of this tree's kernel built with ``WINDOW_CHOICE``
    pinned to the row kernel, as a function of (x, r, out)."""
    import torch

    from topaz_tpu_torch._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
    from topaz_tpu_torch.ops import disk_max as dm
    from topaz_tpu_torch.ops.nms import NEG

    with open(os.path.join(CSRC_DIR, "disk_max.cu")) as f:
        src = f.read()
    if WINDOW_CHOICE not in src:
        sys.exit("profile_torch_disk_max: the launcher's choice of kernel is not "
                 f"`{WINDOW_CHOICE}`; update WINDOW_CHOICE")
    os.makedirs(BUILD_DIR, exist_ok=True)
    copy = os.path.join(BUILD_DIR, "disk_max_rows_alone.cu")
    with open(copy, "w") as f:
        f.write(src.replace(WINDOW_CHOICE, "const bool window = false;"))
    lib = copy[:-3] + ".so"
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib, copy], check=True)
    fn = ctypes.CDLL(lib).disk_max_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(x, r, out):
        B = x.shape[0] if x.dim() == 3 else 1
        H, W = x.shape[-2:]
        err = fn(x.data_ptr(), out.data_ptr(), dm._chord_table(r, x.device).data_ptr(),
                 B, H, W, r, NEG, torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"profile_torch_disk_max: row kernel alone: CUDA error {err}")

    return call


def times_of(root: str) -> list:
    """Device time a call of ``root``'s kernel at every case, through that
    checkout's own wrapper; run in a process of its own."""
    import chip_smoke as cs  # this tree's timer, before root goes first on the path

    sys.path.insert(0, os.path.abspath(root))
    import torch

    from topaz_tpu_torch.ops.disk_max import disk_max
    from topaz_tpu_torch.ops.nms import NEG, disk_max as plain

    g = torch.Generator(device="cuda").manual_seed(0)
    times = []
    for shape, r in CASES:
        x = torch.randn(shape, device="cuda", generator=g)
        if not torch.equal(disk_max(x, r, NEG), plain(x, r, NEG)):
            sys.exit(f"profile_torch_disk_max: {root}'s kernel differs from plain at {shape} r={r}")
        times.append(cs.graph_ms(lambda: disk_max(x, r, NEG), CALLS))
    return times


def run_times_of(root: str) -> list:
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--times-of", root],
                         capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"profile_torch_disk_max: timing {root} failed:\n{out.stdout}{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout whose kernel to time beside this one")
    ap.add_argument("--out", help="directory for disk_max_profile.json")
    ap.add_argument("--times-of", metavar="DIR", help="only time DIR's kernel; print JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_disk_max: no CUDA device")
    if args.times_of:
        print(json.dumps(times_of(args.times_of)))
        return

    import chip_smoke as cs
    from topaz_tpu_torch._build import CSRC_DIR, build_library
    from topaz_tpu_torch.ops.nms import NEG, disk_max as plain

    card = cs.card_line()
    print(f"# card: {card}")
    build_library("disk_max")
    print(ptxas_report(os.path.join(CSRC_DIR, "disk_max.cu")))
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    turns = [run_times_of(args.parent if who == "parent" else REPO) for who in order]
    rows_alone = row_kernel_alone()

    g = torch.Generator(device="cuda").manual_seed(0)
    results = {"card": card, "order": order, "cases": []}
    for i, (shape, r) in enumerate(CASES):
        x = torch.randn(shape, device="cuda", generator=g)
        row = {"shape": list(shape), "r": r,
               "ms": [t[i] for who, t in zip(order, turns) if who == "this"]}
        if args.parent:
            row["parent_ms"] = [t[i] for who, t in zip(order, turns) if who == "parent"]
        want = plain(x, r, NEG)
        out = torch.empty_like(x)
        rows_alone(x, r, out)
        if not torch.equal(out, want):
            sys.exit(f"profile_torch_disk_max: row kernel alone differs from plain at {shape} r={r}")
        row["rows_alone_ms"] = cs.graph_ms(lambda: rows_alone(x, r, out), CALLS)
        row["plain_ms"] = cs.graph_ms(lambda: plain(x, r, NEG), 20)
        row["bound_ms"], row["bound_by"] = cs.disk_max_bound(shape, r, 4)
        print(f"# disk_max f32 {shape} r={r}: kernel "
              f"{' / '.join(f'{t:.5f}' for t in row['ms'])} ms"
              + (f", parent {' / '.join(f'{t:.5f}' for t in row['parent_ms'])} ms"
                 if args.parent else "")
              + f", row kernel alone {row['rows_alone_ms']:.5f} ms"
              + f", plain {row['plain_ms']:.5f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}), {row['bound_ms'] / min(row['ms']):.4f} of it")
        results["cases"].append(row)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "disk_max_profile.json"), "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
