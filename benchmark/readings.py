"""Readings that set a cell's correctness limits, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,... \
        --seconds 3 [--control 3] [--fault em_iters_half] [--out chiprun_out/readings.jsonl]

Runs the cell once a seed in this one process (each run a full run_cell,
set-up included, with a short window) and prints each run's compared
numbers: the lower readings, or with ``--fault`` the readings of the
program with that fault planted in its GMM normalization. With
``--control N`` it then makes the first N seeds' inputs again and judges
the reference computed in TF32 in the program's place: the upper readings.
One JSON line a reading.

Faults of the EM (``topaz_tpu_torch/ops/gmm.gmm_fit``), for the closest
fits the pick check admits (``reference/prep.norm_fit``):

  em_iters_half  every lane capped at half the configuration's steps
  em_tol_8ulp    the stop test's tolerance raised by 8 units of the
                 float32 log-likelihood's last place
"""

import argparse
import json
import os
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def plant(fault: str) -> None:
    import topaz_tpu_torch.ops.gmm as gmm

    real = gmm.gmm_fit
    if fault == "em_iters_half":
        def fit(*args, num_iters=100, **kw):
            return real(*args, num_iters=num_iters // 2, **kw)
    elif fault == "em_tol_8ulp":
        def fit(*args, tol=1e-3, **kw):
            logp = real(*args, tol=tol, **kw)[0]
            ulp = float(logp.abs().amin()) * 2.0 ** -23
            return real(*args, tol=tol + 8 * ulp, **kw)
    else:
        raise ValueError(f"no fault {fault!r}")
    gmm.gmm_fit = fit


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--fault", default=None, choices=("em_iters_half", "em_tol_8ulp"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    import torch

    from harness import cell as cells, check, spec

    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    cell = spec.Cell(spec.load(ROOT), args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    if args.fault:
        plant(args.fault)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds:
        t0 = time.perf_counter()
        result, compared = cells.run_cell(cell, seed, args.seconds, False, t0, "cuda:0", ROOT)
        emit({"workload": cell.name, "side": args.fault or "program", "seed": seed,
              "correct": result["correct"],
              "readings": {k: v["value"] for k, v in compared.items()},
              "metrics": {k: v["value"] for k, v in result["metrics"].items()}})
    ref = check.Reference(cell.config, ROOT, "cuda:0")
    for seed in seeds[:args.control]:
        with tempfile.TemporaryDirectory(prefix="bm-") as workdir:
            readings = cell.driver().control(ref, cell.traffic, seed, "cuda:0", workdir)
        emit({"workload": cell.name, "side": "control_tf32", "seed": seed, "readings": readings})
    return 0


if __name__ == "__main__":
    sys.exit(main())
