"""Nothing the benchmark runs holds JAX or the JAX package: the harness,
every traffic driver, every metric reader and the reference are imported
here and ``sys.modules`` is read; their sources' imports are scanned.
Top-level names are compared whole, since the port's name begins with the
JAX package's."""

import ast
import glob
import os
import subprocess
import sys

from harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "topaz_tpu"}
SOURCES = sorted(glob.glob(os.path.join(spec.BENCH_DIR, "*.py"))
                 + [p for d in ("harness", "drivers", "reference", "metrics")
                    for p in glob.glob(os.path.join(spec.BENCH_DIR, d, "*.py"))])


def test_bm_sources_import_no_jax():
    for path in SOURCES:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)


def test_bm_loaded_modules_hold_no_jax():
    code = (
        "import sys, glob, os\n"
        f"sys.path[:0] = [{spec.BENCH_DIR!r}, {spec.ROOT!r}]\n"
        "from harness import cell, check, inputs, measure, spec, trace\n"
        "import reference.model, reference.prep, reference.nms, reference.counts\n"
        "import readings, run\n"
        "import topaz_tpu_torch.pipeline, topaz_tpu_torch.denoise\n"
        "b = spec.load()\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "for w in b['workloads']:\n"
        "    spec.Cell(b, w['name']).driver()\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "topaz_tpu_torch" in loaded and not loaded & FORBIDDEN
