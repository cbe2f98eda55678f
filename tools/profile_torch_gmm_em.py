#!/usr/bin/env python3
"""Times the GMM's EM kernel (topaz_tpu_torch/csrc/gmm_em.cu) on one NVIDIA
GPU at the callers' shapes: on the plan its wrapper chooses, on every other
plan it could run (each cluster size, both routes where both fit) and,
given ``--parent``, beside the kernel of another checkout on the same card
in the same call.

    python3 tools/profile_torch_gmm_em.py [--parent DIR] [--pipeline] [--out DIR]
    python3 tools/profile_torch_gmm_em.py --refit DIR/gmm_em_profile.json

1. Builds this tree's kernel (``topaz_tpu_torch._build``), prints what
   ``ptxas -v`` says of it (registers, shared memory, spills) and counts
   the SASS instructions of each pixel loop (``cuobjdump -sass``: every
   backward branch closes a loop; a loop's instructions by pipe, over the
   loop's unroll of 4 pixels): with the per-SM rates of compute capability
   9.0 (128 float32 and 128 issued a clock, 16 MUFU, 16 conversions to or
   from float64, 64 float64 adds) it gives the clocks a pixel each pipe
   needs, and so which of them sets the pace.
2. On chip_smoke.py's synthetic mixtures (``em_mixture``, seed 15), the
   five shapes the callers fit: one 512^2 micrograph (``preprocess``), a
   padded bucket of 8 x 512^2 and one of 8 x 768 x 512 with 0/1 weights
   (the pipeline), the 65536-bin histogram of 8 images (``norm_fit_hist``)
   and one 4096^2 micrograph fit whole: each checkout's device time a fit
   through its own wrapper ``ops/gmm._gmm_fit_kernel`` (CUDA events around
   5 launches), each in a process of its own; with ``--parent DIR`` (a
   checkout of another commit, unpacked with ``git archive``) the processes
   take turns: parent, this, this, parent. Every checkout's outputs and
   steps are held against this tree's.
3. In this process, every plan of ``ops/gmm._em_candidates`` at each shape
   (``plan=`` of the wrapper: each cluster size, keeping as many pixels as
   shared memory holds) and beside it the same size keeping none (the
   recompute route), timed alike (3 launches), its
   outputs held against the plan's, beside the bound of
   ``chip_smoke.em_bound``; with ``--pipeline`` also on the pipeline's real
   EM inputs (``chip_smoke.pipeline_em_inputs`` on its 24 synthetic MRCs,
   written to a temporary directory): the two buckets' masked fits, the
   512 x 512 bucket's 65536-bin histogram and one micrograph alone.

Prints the card's name and power limit first; results also go to
``DIR/gmm_em_profile.json`` with ``--out DIR``. ``--times-of DIR --save
FILE`` is the timing process alone: it prints one JSON list of times, one
a shape, and saves the outputs to FILE. Needs a CUDA device, but for
``--refit FILE``: on such a JSON, with no card, the plan ``_em_plan``
would choose at each shape for each fixed step cost (``STEP_COST``) of a
grid, and its time over the fastest planned size's.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (name, B, N, valid pixels or None, histogram bins or 0)
SHAPES = [("1 x 512^2", 1, 512 * 512, False, 0),
          ("8 x 512^2, 0/1 weights", 8, 512 * 512, True, 0),
          ("8 x 768 x 512, 0/1 weights", 8, 768 * 512, True, 0),
          ("8 x 65536 bins", 8, 65536, False, 65536),
          ("1 x 4096^2", 1, 4096 * 4096, False, 0)]
CALLS = 5
# per-SM rates of compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instructions), results a clock: the pipe of each SASS opcode
PIPES = {"fp32": 128, "mufu": 16, "fp64": 64, "conv64": 16, "issue": 128}
UNROLL = 4


def ptxas_report(src: str) -> str:
    from topaz_tpu_torch._build import NVCC_FLAGS, find_nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = subprocess.run([find_nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o", os.devnull, src],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(out.stderr)
    return "\n".join(l for l in out.stderr.splitlines()
                     if "registers" in l or "spill" in l or "Compiling" in l)


def pipe_of(op: str) -> str:
    """The pipe of a SASS opcode, as far as the EM's floor goes."""
    base = op.split(".")[0]
    if base == "MUFU":
        return "mufu"
    if base in ("DADD", "DMUL", "DFMA", "DSETP"):
        return "fp64"
    if base == "F2F" and "F64" in op:
        return "conv64"
    if base in ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK", "FSET"):
        return "fp32"
    return "other"


def sass_loops(so: str):
    """{kernel: [{opcode: count}]} of the innermost loops of each gmm_em
    kernel in ``so`` (a backward branch closes a loop; a loop that holds
    another is not innermost)."""
    from topaz_tpu_torch._build import find_nvcc

    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    loops, name, body = {}, None, []
    line_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)([^;]*);")
    for line in text.splitlines() + ["Function : end"]:
        if "Function :" in line:
            if name and "gmm_em" in name:
                spans = []
                for addr, op, args in body:
                    m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
                    if m and int(m.group(1), 16) < addr:
                        spans.append((int(m.group(1), 16), addr))
                inner = [s for s in spans if not any(
                    o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]
                loops[name] = [collections.Counter(o for a, o, _ in body if s <= a <= e)
                               for s, e in inner]
            name, body = line.split("Function :")[1].strip(), []
            continue
        m = line_re.search(line)
        if m:
            body.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return loops


def sass_pace(so: str) -> list:
    """Each kernel's pixel loops, unrolled 4 times: the largest that
    evaluates the posteriors (MUFU.EX2 in it) and the largest that reads
    kept responsibilities (LDS.64; no MUFU, shuffle or barrier):
    instructions by pipe a pixel and the clocks a pixel each pipe needs on
    one SM."""
    rows = []
    for name, loops in sass_loops(so).items():
        evals = [ops for ops in loops if ops.get("MUFU.EX2")]
        kept = [ops for ops in loops if ops.get("LDS.64") and not any(
            op.startswith(("MUFU", "SHFL", "BAR")) for op in ops)]
        for what, found in (("evaluation", evals), ("kept variance", kept)):
            if not found:
                continue
            ops = max(found, key=lambda o: sum(o.values()))
            size = sum(ops.values())
            by_pipe = collections.Counter()
            for op, k in ops.items():
                by_pipe[pipe_of(op)] += k
            per_pixel = {p: by_pipe[p] / UNROLL for p in ("mufu", "fp32", "fp64", "conv64")}
            per_pixel["issue"] = size / UNROLL
            clocks = {p: per_pixel[p] / PIPES[p] for p in PIPES}
            rows.append({"kernel": name, "loop": what, "instructions": size,
                         "per_pixel": per_pixel, "clocks_per_pixel": clocks,
                         "pace": max(clocks, key=clocks.get),
                         "opcodes": dict(ops.most_common(12))})
    return rows


def make_case(rng, B, N, masked, bins):
    """One shape's fit inputs, as its caller makes them (one launch of the
    importing checkout's kernel)."""
    import chip_smoke as cs
    from topaz_tpu_torch.ops import gmm

    if bins:
        x, _ = cs.em_mixture(rng, B, 4 * N)
        return cs.em_inputs(gmm.norm_fit_hist, x, bins=bins)
    if masked:
        x, w = cs.em_mixture(rng, B, N, rng.integers(N // 2, N + 1, B))
        return cs.em_inputs(gmm.norm_fit, x, w=w)
    x, _ = cs.em_mixture(rng, B, N)
    return cs.em_inputs(gmm.norm_fit, x)


def cases():
    import numpy as np

    rng = np.random.default_rng(15)
    for tag, B, N, masked, bins in SHAPES:
        (xb, wb, n, pi, split), (alpha, beta, scale, num_iters) = make_case(rng, B, N, masked,
                                                                            bins)
        yield tag, (xb, wb, n, pi, split, alpha, beta, scale, 1e-3, num_iters)


def times_of(root: str, save: str) -> list:
    """Device time a fit of ``root``'s kernel at every shape, through that
    checkout's own wrapper; its outputs and steps saved to ``save``. Run in
    a process of its own."""
    import chip_smoke as cs  # this tree's timer and inputs, before root goes first

    sys.path.insert(0, os.path.abspath(root))
    import torch

    from topaz_tpu_torch.ops import gmm

    times, outs = [], []
    for _, fit in cases():
        out, steps = gmm._gmm_fit_kernel(*fit)
        outs.append((torch.stack(out).cpu(), steps.cpu()))
        times.append(cs.cuda_ms(lambda: gmm._gmm_fit_kernel(*fit), CALLS, warmup=1))
    torch.save(outs, save)
    return times


def run_times_of(root: str, save: str) -> list:
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--times-of", root,
                          "--save", save], capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"profile_torch_gmm_em: timing {root} failed:\n{out.stdout}{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def differing(a, b) -> int:
    """Lanes whose outputs or steps differ between two fits' (out, steps)."""
    import torch

    same = (torch.eq(a[0].nan_to_num(), b[0].nan_to_num()).all(0)) & torch.eq(a[1], b[1])
    return int((~same).sum())


def sweep(tag, fit):
    """Every plan of ``_em_candidates`` for one fit, each timed (CUDA events
    around 3 launches) and its outputs held against the device plan's:
    (row, the plan's (out, steps) on the host). Prints the row."""
    import torch

    import chip_smoke as cs
    from topaz_tpu_torch.ops import gmm

    index = torch.cuda.current_device()
    xb, wb, pi = fit[0], fit[1], fit[3]
    (B, N), L = xb.shape, pi.shape[-1]
    plan = gmm._device_plan(index, B, L, N, wb is not None)
    out, steps = gmm._gmm_fit_kernel(*fit)
    ref = (torch.stack(out).cpu(), steps.cpu())
    row = {"case": tag, "shape": [B, N, L], "weighted": wb is not None,
           "max_steps": int(ref[1].max()),
           "plan": {**plan._asdict(), "route": plan.route},
           "plan_ms": cs.cuda_ms(lambda: gmm._gmm_fit_kernel(*fit), 3, warmup=1), "plans": []}
    row["bound_ms"], row["bound_by"] = cs.em_bound(xb, wb, steps)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    active_of = functools.partial(gmm._max_clusters, index)
    for cand, active, cost in gmm._em_candidates(B, L, N, wb is not None, sms,
                                                 gmm._smem_limit(index), active_of):
        plans = [(cand, active, cost)]
        if cand.kept:
            plans.append((cand._replace(kept=0, smem=0),
                          min(active_of(wb is not None, cand.cluster, 0), sms // cand.cluster),
                          None))
        for p, active, cost in plans:
            out, steps = gmm._gmm_fit_kernel(*fit, plan=p)
            got = (torch.stack(out).cpu(), steps.cpu())
            ms = cs.cuda_ms(lambda: gmm._gmm_fit_kernel(*fit, plan=p), 3, warmup=1)
            row["plans"].append({"cluster": p.cluster, "kept": p.kept, "route": p.route,
                                 "smem": p.smem, "active": active, "cost": cost, "ms": ms,
                                 "differing_lanes": differing(got, ref)})
    best = min(row["plans"], key=lambda p: p["ms"])
    print(f"# {tag} (B, N, L) = {(B, N, L)}, the slowest lane {row['max_steps']} steps; plan "
          f"C={plan.cluster} {plan.route}, {plan.kept} of {plan.slice} pixels a block kept, "
          f"{row['plan_ms']:.3f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
          f"fastest plan C={best['cluster']} kept {best['kept']} {best['ms']:.3f} ms", flush=True)
    print("#   every plan: " + "; ".join(
        f"C={p['cluster']} kept {p['kept']} x{p['active']} {p['ms']:.3f} ms"
        + (f" ({p['differing_lanes']} lanes differ)" if p["differing_lanes"] else "")
        for p in row["plans"]), flush=True)
    return row, ref


def refit(path: str) -> None:
    """For each STEP_COST of a grid, the plan ``_em_plan`` chooses at each
    shape of a saved sweep (the card's recorded active clusters and shared
    memory), and its time over the fastest plan ``_em_candidates`` offers."""
    from topaz_tpu_torch.ops import gmm

    with open(path) as f:
        results = json.load(f)
    saved = gmm.STEP_COST
    try:
        for step_cost in range(0, 12001, 1000):
            gmm.STEP_COST = step_cost
            ratios = []
            for row in results["cases"]:
                (B, N, L), planned = row["shape"], [p for p in row["plans"] if p["cost"] is not None]
                active = {(p["cluster"], p["smem"]): p["active"] for p in planned}
                ms = {p["cluster"]: p["ms"] for p in planned}
                plan = gmm._em_plan(B, L, N, row["weighted"], results["sm_count"],
                                    results["smem_limit"],
                                    lambda weighted, c, smem: active.get((c, smem), 0))
                ratios.append((row["case"], plan.cluster, ms[plan.cluster] / min(ms.values())))
            print(f"# STEP_COST {step_cost}: worst {max(r for _, _, r in ratios):.3f} of the "
                  "fastest; " + "; ".join(f"{tag} C={c} {r:.3f}" for tag, c, r in ratios))
    finally:
        gmm.STEP_COST = saved


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout whose kernel to time beside this one")
    ap.add_argument("--out", help="directory for gmm_em_profile.json")
    ap.add_argument("--times-of", metavar="DIR", help="only time DIR's kernel; print JSON")
    ap.add_argument("--save", help="with --times-of: where to save the outputs")
    ap.add_argument("--pipeline", action="store_true",
                    help="also sweep every plan on the pipeline's real EM inputs")
    ap.add_argument("--refit", metavar="FILE",
                    help="rank the plans of a saved gmm_em_profile.json for a grid of STEP_COST")
    args = ap.parse_args()
    if args.refit:
        refit(args.refit)
        return

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_gmm_em: no CUDA device available")
    if args.times_of:
        print(json.dumps(times_of(args.times_of, args.save)))
        return

    import chip_smoke as cs
    from topaz_tpu_torch._build import CSRC_DIR, build_library
    from topaz_tpu_torch.ops import gmm

    card = cs.card_line()
    print(f"# card: {card}", flush=True)
    so = build_library("gmm_em")
    print(ptxas_report(os.path.join(CSRC_DIR, "gmm_em.cu")))
    pace = sass_pace(so)
    for row in pace:
        print(f"# SASS {row['loop']} loop of {row['instructions']} instructions ({UNROLL} "
              f"pixels) in {row['kernel'][-40:]}: a pixel "
              + ", ".join(f"{p} {v:g}" for p, v in row["per_pixel"].items())
              + "; clocks a pixel on one SM "
              + ", ".join(f"{p} {v:.3f}" for p, v in row["clocks_per_pixel"].items())
              + f"; pace: {row['pace']}; top opcodes {row['opcodes']}")

    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    with tempfile.TemporaryDirectory() as tmp:
        turns, saved = [], []
        for i, who in enumerate(order):
            saved.append(os.path.join(tmp, f"{i}.pt"))
            turns.append(run_times_of(args.parent if who == "parent" else REPO, saved[-1]))
        outs = [torch.load(p) for p in saved]
    index = torch.cuda.current_device()
    results = {"card": card, "order": order, "sass": pace, "cases": [],
               "sm_count": torch.cuda.get_device_properties(index).multi_processor_count,
               "smem_limit": gmm._smem_limit(index)}
    for i, (tag, fit) in enumerate(cases()):
        row, ref = sweep(tag, fit)
        row["ms"] = [t[i] for who, t in zip(order, turns) if who == "this"]
        if args.parent:
            row["parent_ms"] = [t[i] for who, t in zip(order, turns) if who == "parent"]
        row["differing_lanes"] = {f"{who} {k}": differing(o[i], ref)
                                  for k, (who, o) in enumerate(zip(order, outs))}
        print(f"# {tag}: ms a fit (in turns) this {' / '.join(f'{t:.3f}' for t in row['ms'])}"
              + (f", parent {' / '.join(f'{t:.3f}' for t in row['parent_ms'])}"
                 if args.parent else "")
              + f"; lanes differing from this tree's fit {row['differing_lanes']}; "
              f"{row['bound_ms'] / min(row['ms']):.4f} of the bound", flush=True)
        results["cases"].append(row)
    if args.pipeline:
        with tempfile.TemporaryDirectory() as workdir:
            paths = cs.write_micrographs(workdir, np.random.default_rng(cs.SEED), cs.GEOMETRIES,
                                         cs.FILES_PER_GEOMETRY)
            for name, (x, w) in cs.pipeline_em_inputs(paths).items():
                fits = [(f"pipeline {name}", cs.em_inputs(gmm.norm_fit, x, w=w))]
                if name == f"bucket_{cs.SIZE // 8}x{cs.SIZE // 8}":
                    fits.append((f"pipeline {name}, 65536 bins",
                                 cs.em_inputs(gmm.norm_fit_hist, x, bins=65536, w=w)))
                for tag, (inputs, (alpha, beta, scale, num_iters)) in fits:
                    row, _ = sweep(tag, inputs + (alpha, beta, scale, cs.EM_TOL, num_iters))
                    results["cases"].append(row)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "gmm_em_profile.json"), "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
