"""``python -m topaz_tpu_torch denoise -d cpu`` against ``python -m topaz_tpu
denoise`` (JAX on the CPU), and the paths the port does not run yet.

The two CLIs denoise the same synthetic micrograph with the bundled unet
and write MRCs that agree to 1e-4 * std of the JAX output (float32
convolutions and FFTs sum in other orders). The second case denoises a
512^2 micrograph at ``--downsample 2 --lowpass 2``, so that the 256^2
image it denoises is cut into ``-s 96 -p 32`` patches, interior and
border."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from topaz_tpu_torch.cli.main import main
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(package, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               TOPAZ_NO_COMPILE_CACHE="1")
    out = subprocess.run([sys.executable, "-m", package] + args, capture_output=True,
                         text=True, cwd=cwd, env=env, timeout=600)
    assert out.returncode == 0, f"{package} {args}:\n{out.stdout}\n{out.stderr}"
    return out


@pytest.mark.parametrize("size,flags", [
    (256, ["-s", "0"]),
    (512, ["--downsample", "2", "--lowpass", "2", "-s", "96", "-p", "32"]),
])
def test_denoise_cli_matches_jax(tmp_path, size, flags):
    x, _ = make_ctf_micrograph(np.random.default_rng(4), size=size, n_particles=size // 512)
    raw = str(tmp_path / "mic.mrc")
    mrc.write(raw, x)
    outputs = {}
    for package, extra in (("topaz_tpu", []), ("topaz_tpu_torch", ["-d", "cpu"])):
        out = str(tmp_path / package)
        _cli(package, ["denoise", "-m", "unet", "-o", out, raw] + flags + extra, tmp_path)
        outputs[package] = mrc.read(os.path.join(out, "mic.mrc"))[0]
    want, got = outputs["topaz_tpu"], outputs["topaz_tpu_torch"]
    expect = size // 2 if "--downsample" in flags else size
    assert got.shape == want.shape == (expect, expect)
    assert np.isfinite(got).all() and not np.allclose(got, mrc.read(raw)[0][:expect, :expect])
    np.testing.assert_allclose(got, want, atol=1e-4 * want.std(), rtol=0)


def test_fast_denoises_in_bf16(tmp_path, capsys):
    """``--fast`` turns on bf16 inference; its output stays within the JAX
    package's bf16 bound (mean abs difference / mean |y_f32| < 0.05)."""
    x = np.random.default_rng(5).normal(0, 2, (96, 96)).astype(np.float32)
    raw = str(tmp_path / "m.mrc")
    mrc.write(raw, x)
    ys = {}
    for tag, extra in (("f32", []), ("fast", ["--fast"])):
        main(["denoise", "-m", "unet-small", "-s", "0", "-d", "cpu",
              "-o", str(tmp_path / tag), raw] + extra)
        ys[tag] = mrc.read(str(tmp_path / tag / "m.mrc"))[0]
    diff = np.mean(np.abs(ys["f32"] - ys["fast"])) / np.mean(np.abs(ys["f32"]))
    assert 0 < diff < 0.05


def test_suffix_and_stack_outputs(tmp_path):
    stack = np.random.default_rng(6).normal(size=(3, 40, 40)).astype(np.float32)
    path = str(tmp_path / "frames.mrcs")
    mrc.write(path, stack)
    main(["denoise", "--stack", "-m", "affine", "-d", "cpu", "-o",
          str(tmp_path / "out.mrcs"), path])
    assert mrc.read(str(tmp_path / "out.mrcs"))[0].shape == stack.shape
    single = str(tmp_path / "one.mrc")
    mrc.write(single, stack[0])
    main(["denoise", "-m", "affine", "unet-small", "-s", "0", "-d", "cpu", single])
    assert mrc.read(str(tmp_path / "one.denoised.mrc"))[0].shape == (40, 40)


@pytest.mark.parametrize("argv", [
    ["denoise", "-d", "-2", "-o", "{d}", "{d}/mic.mrc"],
    ["denoise3d", "-d", "-2", "-o", "{d}", "{d}/mic.mrc"],
    ["segment", "-d", "-2", "-m", "resnet8_u32", "-o", "{d}", "{d}/mic.mrc"],
    ["watch", "-d", "-2", "-o", "{d}/p.txt", "{d}"],
])
def test_not_ported_paths_exit_with_an_error(tmp_path, argv, monkeypatch):
    """``-d -2`` with no GPU exits with the no-device error and writes
    nothing: it never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "model.sav").write_bytes(b"\x80\x02")
    before = sorted(p.name for p in tmp_path.iterdir())
    with pytest.raises(SystemExit) as e:
        main([a.format(d=tmp_path) for a in argv])
    assert "no CUDA device is available" in str(e.value.code)
    assert sorted(p.name for p in tmp_path.iterdir()) == before


def test_denoise3d_device_flag_defaults_to_every_device():
    """``denoise3d -d`` defaults to -2, as the JAX CLI's does."""
    from topaz_tpu.cli.commands import denoise3d as jdenoise3d
    from topaz_tpu_torch.cli.commands import denoise3d as tdenoise3d

    want = jdenoise3d.add_arguments().parse_args(["t.mrc"]).device
    assert tdenoise3d.add_arguments().parse_args(["t.mrc"]).device == want == -2
