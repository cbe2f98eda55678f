"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package (nor pandas), no port file imports them, and its entry points raise
rather than fall back to the CPU when no CUDA device is there."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "topaz_tpu_torch")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    return any(module == m or module.startswith(m + ".")
               for m in ("jax", "jaxlib", "topaz_tpu", "pandas"))


def test_import_loads_no_jax_nor_jax_package():
    code = (
        "import pkgutil, importlib, sys\n"
        "import topaz_tpu_torch\n"
        "for m in pkgutil.walk_packages(topaz_tpu_torch.__path__, 'topaz_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'topaz_tpu', 'pandas'))\n"
        "print(len([m for m in sys.modules if m.startswith('topaz_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20, out.stdout


def test_no_port_file_imports_jax_or_the_jax_package():
    bad = []
    files = _port_files()
    assert len(files) >= 20
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def _entry_points(tmp_path):
    from topaz_tpu_torch.device import resolve_device
    from topaz_tpu_torch.extract import extract_particles
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.models.factory import load_picker
    from topaz_tpu_torch.ops.fourier import downsample
    from topaz_tpu_torch.ops.gmm import normalize
    from topaz_tpu_torch.ops.nms import non_maximum_suppression
    from topaz_tpu_torch.preprocess import normalize_images

    x = np.random.default_rng(0).normal(size=(32, 32)).astype(np.float32)
    path = str(tmp_path / "a.mrc")
    mrc.write(path, x)
    return {
        "resolve_device": lambda: resolve_device(),
        "resolve_device_index": lambda: resolve_device(0),
        "downsample": lambda: downsample(x, 2),
        "normalize": lambda: normalize(x, sample=1),
        "non_maximum_suppression": lambda: non_maximum_suppression(x, 3),
        "load_picker": lambda: load_picker("resnet8_u32"),
        "normalize_images": lambda: normalize_images([path], str(tmp_path / "o")),
        "extract_particles": lambda: extract_particles(
            [path], "resnet8_u32", -6, 3, output=str(tmp_path / "p.txt")),
    }


@pytest.mark.parametrize("entry", [
    "resolve_device", "resolve_device_index", "downsample", "normalize",
    "non_maximum_suppression", "load_picker", "normalize_images",
    "extract_particles"])
def test_entry_points_raise_without_cuda(tmp_path, monkeypatch, entry):
    from topaz_tpu_torch.device import DeviceUnavailableError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        _entry_points(tmp_path)[entry]()


def test_cli_without_cuda_exits_with_an_error(tmp_path, monkeypatch):
    from topaz_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["preprocess", "-s", "2", "-o", str(tmp_path), str(tmp_path / "x.mrc")])
    assert "no CUDA device" in str(e.value.code)
