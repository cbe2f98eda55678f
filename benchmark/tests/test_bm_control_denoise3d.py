"""The control of ``denoise3d.tomo``, on the card: the reference's patch
loop computed in TF32 (the precision below the float32 with TF32 off that
the configuration states) in the program's place reads above the cell's
``denoise_gap`` limit. At the cell's own size ``benchmark/readings.py
--workload denoise3d.tomo --control`` takes these readings; here the
published network (nf 48, a 7^3 first layer, 5 levels) runs on a 96 x 128 x
192 tomogram at ``-s 48 -p 24`` (24 windows of 96^3), so that a test run
holds it.

    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests/test_bm_control_denoise3d.py

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
def test_bm_control_denoise3d_reads_incorrect(seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs TF32 convolutions: it needs a CUDA card")
    cell = spec.Cell(spec.load(), "denoise3d.tomo")
    cfg = dict(cell.config, path=dict(cell.config["path"], patch_size=48, padding=24))
    assert cfg["denoiser3d"]["nf"] == 48 and cfg["denoiser3d"]["base_width"] == 7
    traffic = dict(cell.traffic, shape=[96, 128, 192], volumes=2)
    ref = check.Reference(cfg, spec.ROOT, "cuda:0")
    with tempfile.TemporaryDirectory() as workdir:
        readings = cell.driver().control(ref, traffic, seed, "cuda:0", workdir)
    assert readings["denoise_gap"] > cfg["limits"]["denoise_gap"], readings
