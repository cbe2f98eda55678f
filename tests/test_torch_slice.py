"""The port's main path against the JAX package's, through both CLIs.

A 1024^2 synthetic micrograph goes through ``preprocess -s 8`` and then
``extract -m resnet8_u32 -r 14 -t -6``, once with ``python -m topaz_tpu``
(JAX on the CPU) and once with ``python -m topaz_tpu_torch ... -d cpu``.
The normalized micrographs agree to 1e-4 (float32 FFT, EM and convolution
sums run in other orders), the pick tables hold identical coordinates in
the same order, and their scores agree to 1e-4."""

import os
import subprocess
import sys

import numpy as np

from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(package, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               TOPAZ_NO_COMPILE_CACHE="1")
    out = subprocess.run([sys.executable, "-m", package] + args, capture_output=True,
                         text=True, cwd=cwd, env=env, timeout=600)
    assert out.returncode == 0, f"{package} {args}:\n{out.stdout}\n{out.stderr}"


def _picks(path):
    with open(path) as f:
        header = next(f)
        rows = [line.rstrip("\n").split("\t") for line in f]
    assert header == "image_name\tx_coord\ty_coord\tscore\n"
    coords = np.array([(int(r[1]), int(r[2])) for r in rows])
    return [r[0] for r in rows], coords, np.array([float(r[3]) for r in rows])


def test_preprocess_then_extract_matches_the_jax_cli(tmp_path):
    x, _ = make_ctf_micrograph(np.random.default_rng(3), size=1024, n_particles=8)
    raw = str(tmp_path / "mic.mrc")
    mrc.write(raw, x)
    outputs = {}
    for package, extra in (("topaz_tpu", []), ("topaz_tpu_torch", ["-d", "cpu"])):
        proc = str(tmp_path / f"proc_{package}")
        picks = str(tmp_path / f"picks_{package}.txt")
        _cli(package, ["preprocess", "-s", "8", "-o", proc, raw] + extra, tmp_path)
        _cli(package, ["extract", "-m", "resnet8_u32", "-r", "14", "-t", "-6",
                       "-o", picks, os.path.join(proc, "mic.mrc")] + extra, tmp_path)
        outputs[package] = (mrc.read(os.path.join(proc, "mic.mrc"))[0], _picks(picks))

    (jimg, (jnames, jcoords, jscores)) = outputs["topaz_tpu"]
    (timg, (tnames, tcoords, tscores)) = outputs["topaz_tpu_torch"]
    assert timg.shape == jimg.shape == (128, 128)
    np.testing.assert_allclose(timg, jimg, atol=1e-4, rtol=0)
    assert len(jcoords) >= 10
    assert tnames == jnames
    np.testing.assert_array_equal(tcoords, jcoords)
    np.testing.assert_allclose(tscores, jscores, atol=1e-4, rtol=0)
