"""The control, on the card: the reference computed in TF32 (the precision
below the float32 with TF32 off that the configurations state) in the
program's place reads above every cell's limits. At the cells' own sizes
``benchmark/readings.py --control`` takes these readings; here the inputs
are a quarter of a side, so that a test run holds them.

    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests/test_bm_control.py

(``--noconftest`` keeps out the repository's JAX test fixtures; this file
puts ``benchmark/`` on the path itself.)
"""

import os
import sys
import tempfile

import pytest

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]

from harness import check, spec  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["session.mixed", "denoise.full"])
def test_bm_control_reads_incorrect(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs TF32 convolutions: it needs a CUDA card")
    cell = spec.Cell(spec.load(), name)
    t = dict(cell.traffic)
    t["cameras"] = [dict(c, shape=[c["shape"][0] // 4, c["shape"][1] // 4], files=2)
                    for c in t["cameras"]]
    t["micrograph"] = dict(t["micrograph"], particle_radius_px=28)
    ref = check.Reference(cell.config, spec.ROOT, "cuda:0")
    limits = cell.config["limits"]
    for seed in (1, 2, 3):
        with tempfile.TemporaryDirectory() as workdir:
            readings = cell.driver().control(ref, t, seed, "cuda:0", workdir)
        assert any(v > limits[k] for k, v in readings.items()), readings
