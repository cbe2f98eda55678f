#!/usr/bin/env python3
"""Times the GMM's EM kernel (topaz_tpu_torch/csrc/gmm_em.cu) on one NVIDIA
GPU against variants of its own source: its block of 1024 threads with the
pixel loops unrolled 4 times, as built, against the same without the unroll
and with 512 threads.

    python3 tools/profile_torch_gmm_em.py [--out DIR]

1. Builds this tree's kernel (``topaz_tpu_torch._build``) and each variant
   (a copy of the source under ``topaz_tpu_torch/_build/`` with the line
   that sets the block or the unroll replaced), and prints what ``ptxas
   -v`` says of each (registers, shared memory, spills).
2. On chip_smoke.py's synthetic mixtures (``em_mixture``, seed 15): a
   padded bucket of 8 x 512^2 with 0/1 weights (``norm_fit``'s lanes), one
   512^2 image unweighted, and the 65536-bin histogram fit of 8 images
   (``norm_fit_hist``): each build's device time a fit through the port's
   wrapper ``ops/gmm._gmm_fit_kernel`` (CUDA events around 5 launches), in
   turns (as built, the variants, then back again), each build's outputs
   and steps held equal to the built kernel's, beside the bound of
   ``chip_smoke.em_bound``.

Prints the card's name and power limit first; results also go to
``DIR/gmm_em_profile.json`` with ``--out DIR``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the lines of csrc/gmm_em.cu that the variants replace
THREADS = "constexpr int kThreads = 1024;"
UNROLL = "#pragma unroll 4\n"
VARIANTS = {"1024 threads, no unroll": [(UNROLL, "")],
            "512 threads, no unroll": [(UNROLL, ""),
                                       (THREADS, "constexpr int kThreads = 512;")]}


def build_variant(name: str, edits):
    """The source with ``edits`` applied and the library built from it:
    (source path, library path)."""
    from topaz_tpu_torch._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc

    with open(os.path.join(CSRC_DIR, "gmm_em.cu")) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            sys.exit(f"profile_torch_gmm_em: csrc/gmm_em.cu has no {old!r}; update the tool")
        src = src.replace(old, new)
    tag = name.replace(" ", "_").replace(",", "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"gmm_em_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = path[:-3] + ".so"
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib, path], check=True)
    return path, lib


def ptxas_report(src: str) -> str:
    from topaz_tpu_torch._build import NVCC_FLAGS, find_nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = subprocess.run([find_nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o", os.devnull, src],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(out.stderr)
    return "\n".join(l for l in out.stderr.splitlines() if "registers" in l or "spill" in l)


@contextlib.contextmanager
def using(lib):
    """Within it, the port's wrapper launches the kernel of ``lib``."""
    from topaz_tpu_torch.ops import gmm

    built = gmm._library
    gmm._library = lambda: lib
    try:
        yield
    finally:
        gmm._library = built


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="directory for gmm_em_profile.json")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_gmm_em: no CUDA device available")
    import chip_smoke as cs
    from topaz_tpu_torch._build import CSRC_DIR
    from topaz_tpu_torch.ops import gmm

    print(f"# card: {cs.card_line()}")
    libs = {"as built": gmm._library()}
    print(f"# as built:\n{ptxas_report(os.path.join(CSRC_DIR, 'gmm_em.cu'))}")
    for name, edits in VARIANTS.items():
        src, so = build_variant(name, edits)
        lib = ctypes.CDLL(so)
        lib.gmm_em_f32.argtypes = libs["as built"].gmm_em_f32.argtypes
        lib.gmm_em_f32.restype = ctypes.c_int
        libs[name] = lib
        print(f"# {name}:\n{ptxas_report(src)}")

    rng = np.random.default_rng(15)
    cases = []
    x, w = cs.em_mixture(rng, 8, 512 * 512, rng.integers(131072, 262145, 8))
    cases.append(("8 x 512^2, 0/1 weights", cs.em_inputs(gmm.norm_fit, x, w=w)))
    x, _ = cs.em_mixture(rng, 1, 512 * 512)
    cases.append(("1 x 512^2", cs.em_inputs(gmm.norm_fit, x)))
    x, _ = cs.em_mixture(rng, 8, 4 * 65536)
    cases.append(("8 x 65536 bins", cs.em_inputs(gmm.norm_fit_hist, x, bins=65536)))
    order = list(libs) + list(libs)[::-1]
    rows = []
    for tag, ((xb, wb, n, pi, split), (alpha, beta, scale, num_iters)) in cases:
        fit = (xb, wb, n, pi, split, alpha, beta, scale, cs.EM_TOL, num_iters)
        times, outs = {name: [] for name in libs}, {}
        for name in order:
            with using(libs[name]):
                out, steps = gmm._gmm_fit_kernel(*fit)
                outs[name] = torch.stack(out), steps
                times[name].append(cs.cuda_ms(lambda: gmm._gmm_fit_kernel(*fit), 5, warmup=1))
        ref = outs["as built"]
        for name, (out, steps) in outs.items():
            if not (torch.equal(out.nan_to_num(), ref[0].nan_to_num())
                    and torch.equal(steps, ref[1])):
                sys.exit(f"profile_torch_gmm_em: {name} differs from the built kernel on {tag}")
        bound, by = cs.em_bound(xb, wb, ref[1])
        rows.append({"case": tag, "shape": [xb.shape[0], xb.shape[1], pi.shape[-1]],
                     "max_steps": int(ref[1].max()), "ms": times, "bound_ms": bound,
                     "bound_by": by})
        print(f"# {tag} (B, N, L) = {tuple(rows[-1]['shape'])}, the slowest lane "
              f"{rows[-1]['max_steps']} steps; ms a fit (in turns): "
              + "; ".join(f"{name} {' / '.join(f'{t:.3f}' for t in ts)}"
                          for name, ts in times.items())
              + f"; outputs equal; bound {bound:.4f} ms ({by})")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "gmm_em_profile.json"), "w") as f:
            json.dump({"card": cs.card_line(), "cases": rows}, f, indent=1)


if __name__ == "__main__":
    main()
