"""The control of ``extract3d.tomo``, on the card: the reference computed
in TF32 (the precision below the float32 with TF32 off that the
configuration states) in the program's place, its threshold from its own
map and its greedy sphere picks judged against the float32 reference's
map, reads above the cell's ``pick_gap`` limit. At the cell's own size
``benchmark/readings.py --workload extract3d.tomo --control`` takes these
readings; here the published picker (ResNet8, units 32) runs on a 64 x 128
x 160 tomogram, so that a test run holds it.

    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests/test_bm_control_extract3d.py

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
@pytest.mark.parametrize("seed", [3000000001, 3000000002, 3000000003])
def test_bm_control_extract3d_reads_incorrect(seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs TF32 convolutions: it needs a CUDA card")
    cell = spec.Cell(spec.load(), "extract3d.tomo")
    cfg = cell.config
    assert cfg["picker3d"]["units"] == 32 and cfg["picker3d"]["layers"][-1]["cout"] == 128
    traffic = dict(cell.traffic, shape=[64, 128, 160])
    ref = check.Reference(cfg, spec.ROOT, "cuda:0")
    with tempfile.TemporaryDirectory() as workdir:
        readings = cell.driver().control(ref, traffic, seed, "cuda:0", workdir)
    print(f"extract3d control, seed {seed}: {readings}")
    assert readings["pick_gap"] > cfg["limits"]["pick_gap"], readings
