"""Run one cell of the benchmark of ``topaz_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic and
its metrics are found by name from ``BENCHMARK.json``. The last line of
standard output is the run's result as one JSON object; the numbers
compared against the reference, each with its limit, are the last lines of
standard error and the result's last key. Exits non-zero with no result
where no CUDA card (or too few) is visible, or where the process holds JAX
or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# kernel caches at fixed places inside the checkout: only a checkout's
# first run builds
CACHE = os.path.join(ROOT, ".bench_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    for path in (BENCH_DIR, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)

    import torch

    from harness import cell as cells, spec

    cell = spec.Cell(spec.load(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result, compared = cells.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START,
                                      device="cuda:0", root=ROOT)
    bad = cells.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
