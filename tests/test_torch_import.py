"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package (nor pandas, nor h5py, which only the ``--hdf`` sampler imports,
nor PIL, which only the image writers and readers import, inside their
functions), no port file imports them, and its entry points raise rather than fall back
to the CPU when no CUDA device is there."""

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
        "('jax', 'jaxlib', 'topaz_tpu', 'pandas', 'h5py', 'PIL'))\n"
        "print(len([m for m in sys.modules if m.startswith('topaz_tpu_torch')]), bad)\n"
        "print(' '.join(sorted(m for m in sys.modules if m.startswith('topaz_tpu_torch'))))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20, out.stdout
    scanned = set(out.stdout.splitlines()[1].split())
    assert {"topaz_tpu_torch.train.denoise_data", "topaz_tpu_torch.cli.commands.denoise3d",
            "topaz_tpu_torch.denoise", "topaz_tpu_torch.models.denoise_factory",
            "topaz_tpu_torch.models.tiling", "topaz_tpu_torch.cli.commands.downsample",
            "topaz_tpu_torch.models.generative",
            "topaz_tpu_torch.cli.commands.precision_recall_curve",
            "topaz_tpu_torch.io.table", "topaz_tpu_torch.models.convert",
            "topaz_tpu_torch.segment", "topaz_tpu_torch.cli.commands.convert",
            "topaz_tpu_torch.cli.commands.particle_stack", "topaz_tpu_torch.cli.commands.gui",
            "topaz_tpu_torch.cli.commands.segment",
            "topaz_tpu_torch.cli.commands.train_test_split", "topaz_tpu_torch.serve",
            "topaz_tpu_torch.watch", "topaz_tpu_torch.warmup", "topaz_tpu_torch.predict",
            "topaz_tpu_torch.utils.signals", "topaz_tpu_torch.cli.commands.serve",
            "topaz_tpu_torch.cli.commands.watch",
            "topaz_tpu_torch.cli.commands.warmup", "topaz_tpu_torch.transform",
            "topaz_tpu_torch.transform.scaled_gaussian_mixture",
            "topaz_tpu_torch.models.extras", "topaz_tpu_torch.parallel",
            "topaz_tpu_torch.parallel.devices", "topaz_tpu_torch.parallel.mesh"} <= scanned


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


def test_h5py_is_imported_only_by_the_hdf_sampler():
    """h5py is not on the card's machine: only ``make_hdf5_samplers`` (the
    ``--hdf`` branch) imports it, inside the function."""
    where = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for fn in [None] + [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]:
            body = tree.body if fn is None else fn.body
            for node in body:
                if isinstance(node, ast.Import) and any(a.name == "h5py" for a in node.names):
                    where.append((os.path.relpath(path, REPO), fn and fn.name))
    assert where == [("topaz_tpu_torch/train/denoise_data.py", "make_hdf5_samplers")], where


def test_pinned_blocks_and_copy_events_live_only_in_transfer():
    """Pinned host memory a module allocates and holds (the keyword
    ``pin_memory=``) and the CUDA events behind host<->device copies
    (``torch.cuda.Event(``) belong to ``transfer.py`` alone, which reuses a
    block only once the copy behind it has finished."""
    where = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        if not rel.startswith("topaz_tpu_torch" + os.sep):
            continue
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if any(k.arg == "pin_memory" for k in node.keywords):
                where.append((rel, "pin_memory="))
            if ast.unparse(node.func) == "torch.cuda.Event":
                where.append((rel, "torch.cuda.Event("))
    assert {rel for rel, _ in where} == {os.path.join("topaz_tpu_torch", "transfer.py")}, where


def _entry_points(tmp_path):
    from topaz_tpu_torch.device import resolve_device
    from topaz_tpu_torch.extract import extract_particles
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.models.factory import load_picker
    from topaz_tpu_torch.ops.fourier import downsample
    from topaz_tpu_torch.ops.gmm import normalize
    from topaz_tpu_torch.ops.nms import non_maximum_suppression
    from topaz_tpu_torch.pipeline import MicrographPipeline
    from topaz_tpu_torch.preprocess import normalize_images, normalize_images_batched
    from topaz_tpu_torch.cli.commands import train as train_cli
    from topaz_tpu_torch.models.factory import new_picker
    from topaz_tpu_torch.training import train_model
    from topaz_tpu_torch.denoise import Denoise, Denoise3D
    from topaz_tpu_torch.io.image import downsample_file
    from topaz_tpu_torch.ops.nms import exact_non_maximum_suppression, non_maximum_suppression_3d
    from topaz_tpu_torch.ops.fourier import downsample_3d, lowpass
    from topaz_tpu_torch.predict import score
    from topaz_tpu_torch.serve import TopazService
    from topaz_tpu_torch.warmup import warmup
    from topaz_tpu_torch.watch import watch_directory

    x = np.random.default_rng(0).normal(size=(32, 32)).astype(np.float32)
    path = str(tmp_path / "a.mrc")
    mrc.write(path, x)
    vol = str(tmp_path / "v.mrc")
    mrc.write(vol, np.zeros((8, 8, 8), np.float32))
    targets = str(tmp_path / "targets.txt")
    with open(targets, "w") as f:
        f.write("image_name\tx_coord\ty_coord\na\t3\t4\n")
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
        "extract_particles_batched": lambda: extract_particles(
            [path], "resnet8_u32", -6, 3, batch_size=2, output=str(tmp_path / "p.txt")),
        "MicrographPipeline": lambda: MicrographPipeline(scale=1),
        "normalize_images_batched": lambda: normalize_images_batched(
            [path], str(tmp_path / "o"), batch_size=2),
        "new_picker": lambda: new_picker("resnet8"),
        "train_model": lambda: train_model(train_cli.add_arguments().parse_args(
            ["--train-images", str(tmp_path), "--train-targets", str(tmp_path / "t.txt"),
             "-n", "5"])),
        "Denoise3D": lambda: Denoise3D.from_arch("unet-small", nf=4),
        "Denoise_from_arch": lambda: Denoise.from_arch("unet", nf=4),
        "extract_targets": lambda: extract_particles(
            [path], "none", -6, None, targets=targets),
        "extract_only_validate": lambda: extract_particles(
            [path], "none", -6, 3, targets=targets, only_validate=True),
        "extract_per_micrograph": lambda: extract_particles(
            [path], "none", -6, 3, per_micrograph=True, output=str(tmp_path)),
        "extract_per_micrograph_batched": lambda: extract_particles(
            [path], "resnet8_u32", -6, 3, batch_size=2, per_micrograph=True,
            output=str(tmp_path)),
        "extract_patch_size": lambda: extract_particles(
            [path], "resnet8_u32", -6, 3, patch_size=16, output=str(tmp_path / "p.txt")),
        "extract_dims3": lambda: extract_particles(
            [vol], "none", -6, 3, dims=3, output=str(tmp_path / "p.txt")),
        "non_maximum_suppression_3d": lambda: non_maximum_suppression_3d(
            np.zeros((4, 4, 4), np.float32), 1),
        "downsample_file": lambda: downsample_file(path, 2, str(tmp_path / "d.mrc")),
        "train_model_dims3": lambda: train_model(train_cli.add_arguments().parse_args(
            ["--train-images", str(tmp_path), "--train-targets", str(tmp_path / "t.txt"),
             "-n", "5", "--dims", "3", "--augment-3d"])),
        "train_model_autoencoder": lambda: train_model(train_cli.add_arguments().parse_args(
            ["--train-images", str(tmp_path), "--train-targets", str(tmp_path / "t.txt"),
             "-n", "5", "--autoencoder", "1"])),
        "exact_non_maximum_suppression": lambda: exact_non_maximum_suppression(x, 3),
        "downsample_3d": lambda: downsample_3d(np.zeros((8, 8, 8), np.float32), 2),
        "lowpass_3d": lambda: lowpass(np.zeros((8, 8, 8), np.float32), 2, dims=3),
        "predict_score": lambda: score(new_picker("resnet8", units=4, device="cpu"), [x]),
        "TopazService": lambda: TopazService(model="resnet8_u32"),
        "watch_directory": lambda: watch_directory(str(tmp_path), str(tmp_path / "p.txt"),
                                                   once=True),
        "warmup": lambda: warmup(model="resnet8_u32", shapes=((32, 32),)),
    }


@pytest.mark.parametrize("entry", [
    "resolve_device", "resolve_device_index", "downsample", "normalize",
    "non_maximum_suppression", "load_picker", "normalize_images",
    "extract_particles", "extract_particles_batched", "MicrographPipeline",
    "normalize_images_batched", "new_picker", "train_model", "Denoise3D",
    "Denoise_from_arch", "extract_targets", "extract_only_validate",
    "extract_per_micrograph", "extract_per_micrograph_batched", "extract_patch_size",
    "extract_dims3", "non_maximum_suppression_3d", "downsample_file", "train_model_dims3",
    "train_model_autoencoder", "exact_non_maximum_suppression", "downsample_3d", "lowpass_3d",
    "predict_score", "TopazService", "watch_directory", "warmup"])
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


@pytest.mark.parametrize("argv", [
    ["downsample", "-s", "2", "-o", "{d}/y.mrc", "{d}/x.mrc"],
    ["extract", "-m", "none", "--dims", "3", "-r", "3", "{d}/x.mrc"],
    ["extract", "-m", "none", "--targets", "{d}/t.txt", "{d}/x.mrc"],
])
def test_extract_and_downsample_cli_without_cuda_exit_with_an_error(tmp_path, monkeypatch, argv):
    from topaz_tpu_torch.cli.main import main
    from topaz_tpu_torch.io import mrc

    mrc.write(str(tmp_path / "x.mrc"), np.zeros((8, 8), np.float32))
    (tmp_path / "t.txt").write_text("image_name\tx_coord\ty_coord\nx\t3\t4\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main([a.format(d=tmp_path) for a in argv])
    assert "no CUDA device" in str(e.value.code)
