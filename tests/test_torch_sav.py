"""Reference ``.sav`` models in the port against the JAX package, on the CPU.

Fixtures are built here, with no download: state-dict ``.sav`` files from
the JAX package's ``export_picker_sav`` (``resnet8_u32``, ``resnet16_u32``)
and ``export_denoiser_sav`` (``unet_L2_v0.2.1``), and whole-module ``.sav``
files in the zip and the legacy format, written by ``torch.save`` of
stand-in modules registered under the reference's module and class names
(``topaz.model.classifier.LinearClassifier``,
``topaz.model.features.resnet.ResidA``, ...,
``topaz.denoising.models.UDenoiseNet3``). The JAX reader reads each with
its restricted unpickler (its ``torch.load`` fallback would warn, and a
warning fails the test).

The port's parameters equal the JAX package's bit for bit; dense scores
agree within atol 1e-4, rtol 1e-4 (``tests/test_torch_picker.py``'s
tolerance: float32 convolutions in two libraries). ``.sav`` files written
by the port load in ``torch.load(weights_only=True)`` and in the JAX
``load_sav``. A crafted pickle raises without running its payload, with
torch importable, and no file of the port calls ``torch.load`` with
``weights_only=False``. ``extract``, ``train`` and ``denoise`` take
``-m x.sav``.
"""

import os
import pickle
import sys
import types
import warnings
import zipfile

import numpy as np
import pytest
import torch
from torch import nn

from topaz_tpu.models import convert as jconvert
from topaz_tpu.models import denoise_factory as jdfactory
from topaz_tpu.models import factory as jfactory
from topaz_tpu.models.picker import apply_picker
from topaz_tpu_torch.cli.main import main as tmain
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.models import convert as tconvert
from topaz_tpu_torch.models import denoise_factory as tdfactory
from topaz_tpu_torch.models import factory as tfactory
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 or got[k].shape == (), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_quiet(fn, *args):
    """A JAX call that must not fall back to torch.load (which warns)."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return fn(*args)


@pytest.fixture(scope="module")
def state_dict_savs(tmp_path_factory):
    d = tmp_path_factory.mktemp("savs")
    out = {}
    for name in ("resnet8_u32", "resnet16_u32"):
        out[name] = str(d / f"{name}.sav")
        jconvert.export_picker_sav(out[name], name)
    out["unet"] = str(d / "unet.sav")
    jconvert.export_denoiser_sav(out["unet"], "unet-v0.2.1")
    return out


@pytest.mark.parametrize("name", ["resnet8_u32", "resnet16_u32"])
def test_state_dict_picker_sav_equals_jax(state_dict_savs, name):
    spec, params, state = _jax_quiet(jfactory.load_picker, state_dict_savs[name])
    model = tfactory.load_picker(state_dict_savs[name], device="cpu")
    got_params, got_state = tfactory.picker_to_numpy(model)
    _assert_trees_equal(got_params, params)
    assert model.spec.arch == spec.arch and model.spec.width == spec.width
    _, bundled_params, _ = jfactory.load_picker(name)
    _assert_trees_equal(got_params, bundled_params)
    x = np.random.default_rng(1).normal(size=(1, 64, 72)).astype(np.float32)
    want, _ = apply_picker(spec, params, x, state=state, dense=True, precision="highest")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_state_dict_denoiser_sav_equals_jax(state_dict_savs):
    meta, params = _jax_quiet(jdfactory.load_denoiser, state_dict_savs["unet"])
    model = tdfactory.load_denoiser(state_dict_savs["unet"], device="cpu")
    got_meta, got_params = tdfactory.denoiser_to_numpy(model)
    assert got_meta == meta == {"arch": "unet", "nf": 48, "base_width": 7, "top_width": 3,
                                "dims": 2}
    _assert_trees_equal(got_params, params)
    _assert_trees_equal(got_params, jdfactory.load_denoiser("unet-v0.2.1")[1])


# -- whole-module .sav files of stand-in modules under the reference's names ----

def _standin_class(module: str, name: str, monkeypatch):
    parts = module.split(".")
    for i in range(1, len(parts) + 1):
        mod = ".".join(parts[:i])
        if mod not in sys.modules or not getattr(sys.modules[mod], "_standin", False):
            m = types.ModuleType(mod)
            m._standin = True
            monkeypatch.setitem(sys.modules, mod, m)
    cls = getattr(sys.modules[module], name, None)
    if cls is None:
        cls = type(name, (nn.Module,), {"__module__": module, "__qualname__": name})
        setattr(sys.modules[module], name, cls)
    return cls


def _leaf(shape_w, has_bias):
    """A torch layer holding a weight of ``shape_w`` (and a bias)."""
    if len(shape_w) == 4:
        return nn.Conv2d(shape_w[1], shape_w[0], shape_w[2:], bias=has_bias)
    return nn.PReLU(shape_w[0])


def _standin_module(sd, classes, monkeypatch):
    """A module tree holding ``sd``: containers of the classes ``classes``
    gives by dotted path (the root under ''), torch layers as leaves."""
    def make(path):
        module, name = classes.get(path, ("torch.nn.modules.module", "Module"))
        if module.startswith("torch"):
            return nn.Sequential() if name == "Sequential" else nn.Module()
        return _standin_class(module, name, monkeypatch)()

    root = make("")
    leaves = sorted({k.rsplit(".", 1)[0] for k in sd})
    for path in leaves:
        parts = path.split(".")
        node = root
        for i, p in enumerate(parts[:-1]):
            if p not in node._modules:
                node.add_module(p, make(".".join(parts[:i + 1])))
            node = node._modules[p]
        leaf = _leaf(sd[path + ".weight"].shape, path + ".bias" in sd)
        with torch.no_grad():
            for k in ("weight", "bias"):
                if path + "." + k in sd:
                    getattr(leaf, k).copy_(torch.from_numpy(np.array(sd[path + "." + k])))
        node.add_module(parts[-1], leaf)
    return root.eval()


def _picker_classes(sd):
    classes = {"": ("topaz.model.classifier", "LinearClassifier"),
               "features": ("topaz.model.features.resnet", "ResNet8"),
               "features.features": ("torch.nn.modules.container", "Sequential")}
    for k in sd:
        if k.startswith("features.features."):
            i = k.split(".")[2]
            kind = "ResidA" if f"features.features.{i}.conv0.weight" in sd else "BasicConv"
            classes[f"features.features.{i}"] = ("topaz.model.features.resnet", kind)
    return classes


@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_whole_module_picker_sav_equals_jax(tmp_path, monkeypatch, legacy):
    sd = tconvert.load_sav(_export(tmp_path, "resnet8_u32"))
    module = _standin_module(sd, _picker_classes(sd), monkeypatch)
    path = str(tmp_path / "whole.sav")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the legacy writer cannot read stand-ins' source
        torch.save(module, path, _use_new_zipfile_serialization=not legacy)
    assert zipfile.is_zipfile(path) != legacy
    obj = tconvert.load_sav(path)
    assert type(obj).__name__ == "LinearClassifier"
    assert [type(m).__name__ for m in obj.features.features] == [
        "BasicConv", "ResidA", "ResidA", "ResidA", "BasicConv"]
    spec, params, state = _jax_quiet(jfactory.load_picker, path)
    model = tfactory.load_picker(path, device="cpu")
    assert model.spec.arch == spec.arch == "resnet8"
    _assert_trees_equal(tfactory.picker_to_numpy(model)[0], params)
    _assert_trees_equal(params, jfactory.load_picker("resnet8_u32")[1])


def _export(tmp_path, name):
    path = str(tmp_path / f"{name}.sav")
    tconvert.export_picker_sav(path, name)
    return path


@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_whole_module_udenoisenet3_class_rule(tmp_path, monkeypatch, legacy):
    """UDenoiseNet3 has UDenoiseNet's shapes; its class name makes it the
    residual arch in both packages."""
    path = str(tmp_path / "unet.sav")
    tconvert.export_denoiser_sav(path, "unet-v0.2.1")
    sd = tconvert.load_sav(path)
    module = _standin_module(sd, {"": ("topaz.denoising.models", "UDenoiseNet3")}, monkeypatch)
    whole = str(tmp_path / "unet3.sav")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.save(module, whole, _use_new_zipfile_serialization=not legacy)
    meta, params = _jax_quiet(jdfactory.load_denoiser, whole)
    model = tdfactory.load_denoiser(whole, device="cpu")
    got_meta, got_params = tdfactory.denoiser_to_numpy(model)
    assert got_meta == meta and meta["arch"] == "unet3"
    _assert_trees_equal(got_params, params)


def test_written_sav_loads_in_torch_and_jax(tmp_path):
    rng = np.random.default_rng(4)
    sd = {"a.weight": rng.normal(size=(3, 2, 5, 5)).astype(np.float32),
          "a.bias": rng.normal(size=3).astype(np.float32),
          "b": np.float32(2.5), "c.running_var": np.arange(4, dtype=np.float64)}
    path = str(tmp_path / "w.sav")
    tconvert.write_sav(path, sd)
    loaded = torch.load(path, weights_only=True)
    jloaded = _jax_quiet(jconvert.load_sav, path)
    assert list(loaded) == list(sd) == list(jloaded)
    for k, v in sd.items():
        want = np.asarray(v, dtype=np.float32)
        np.testing.assert_array_equal(loaded[k].numpy(), want)
        np.testing.assert_array_equal(jloaded[k], want)
    # the JAX writer (with torch importable) writes the same bytes
    jpath = str(tmp_path / "w_jax.sav")
    jconvert.write_sav(jpath, sd)
    with zipfile.ZipFile(path) as a, zipfile.ZipFile(jpath) as b:
        assert [(i.filename.split("/", 1)[1], a.read(i)) for i in a.infolist()] == [
            (i.filename.split("/", 1)[1], b.read(i)) for i in b.infolist()]


def test_exported_picker_sav_loads_back_everywhere(tmp_path):
    path = _export(tmp_path, "resnet16_u32")
    sd = torch.load(path, weights_only=True)
    assert "features.features.0.conv.weight" in sd and "classifier.bias" in sd
    spec, params, _ = _jax_quiet(jfactory.load_picker, path)
    _assert_trees_equal(params, jfactory.load_picker("resnet16_u32")[1])
    with pytest.raises(ImportError, match="reference 'topaz' package"):
        tconvert.export_picker_sav(str(tmp_path / "whole.sav"), "resnet8_u32",
                                   whole_module=True)
    with pytest.raises(ImportError, match="reference 'topaz' package"):
        tconvert.export_denoiser_sav(str(tmp_path / "whole.sav"), "affine", whole_module=True)


def test_basic_conv_sav_is_refused(tmp_path):
    """The reference BasicConv layout (conv31/63/127) is refused in both
    packages, as tests/test_picker_models.py pins for the JAX package."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "conv31.sav")
    tconvert.write_sav(path, {"features.features.0.weight": rng.normal(size=(8, 1, 7, 7)),
                              "features.features.0.bias": np.zeros(8),
                              "classifier.weight": rng.normal(size=(1, 8, 1, 1)),
                              "classifier.bias": np.zeros(1)})
    for load in (lambda: tfactory.load_picker(path, device="cpu"),
                 lambda: _jax_quiet(jfactory.load_picker, path)):
        with pytest.raises(ValueError, match="conv31/63/127"):
            load()


def test_malicious_pickles_do_not_run(tmp_path):
    """A crafted legacy preamble and a crafted zip data.pkl, each a
    GLOBAL+REDUCE payload, raise without running it, torch importable."""
    assert "torch" in sys.modules
    marker = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            return (os.system, (f"touch {marker}",))

    legacy = tmp_path / "evil.sav"
    legacy.write_bytes(pickle.dumps(Evil()) + b"\x00" * 64)
    zipped = tmp_path / "evil_zip.sav"
    with zipfile.ZipFile(zipped, "w") as zf:
        zf.writestr("evil/data.pkl", pickle.dumps({"w": Evil()}))
        zf.writestr("evil/version", "3\n")
    for path in (legacy, zipped):
        with pytest.raises(tconvert.SavFormatError, match="refusing to unpickle posix.system"):
            tconvert.load_sav(str(path))
        with pytest.raises(tconvert.SavFormatError, match="never unpickled freely"):
            tfactory.load_picker(str(path), device="cpu")
        with open(path, "rb") as f:
            with pytest.raises(tconvert.SavFormatError):
                tconvert.load_sav(f)
    assert not marker.exists(), "a crafted .sav ran its payload"


def test_no_port_file_unpickles_freely():
    """No call of the port passes ``weights_only=False``, and none calls
    ``torch.load`` or ``pickle.load(s)``."""
    import ast

    hits = []
    for root, _, names in os.walk(os.path.join(REPO, "topaz_tpu_torch")):
        for name in (n for n in names if n.endswith(".py")):
            with open(os.path.join(root, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                if any(k.arg == "weights_only" and getattr(k.value, "value", None) is False
                       for k in node.keywords):
                    hits.append((name, node.lineno))
                func = node.func
                if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                        and (func.value.id, func.attr) in {("torch", "load"), ("pickle", "load"),
                                                           ("pickle", "loads")}):
                    hits.append((name, node.lineno))
    assert hits == []


def test_cli_commands_take_a_sav(tmp_path, state_dict_savs):
    """``extract -m x.sav`` picks as the bundled alias; ``denoise -m x.sav``
    denoises as the alias; ``train -m x.sav`` fine-tunes from it."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 80)).astype(np.float32)
    mic = str(tmp_path / "mic.mrc")
    mrc.write(mic, x)
    for model, tag in ((state_dict_savs["resnet8_u32"], "sav"), ("resnet8_u32", "alias")):
        tmain(["extract", "-m", model, "-r", "6", "-t", "-10", "-o", str(tmp_path / f"{tag}.txt"),
               "-d", "cpu", mic])
    sav_picks = (tmp_path / "sav.txt").read_text()
    assert sav_picks == (tmp_path / "alias.txt").read_text() and sav_picks.count("\n") > 2
    for model, tag in ((state_dict_savs["unet"], "sav"), ("unet-v0.2.1", "alias")):
        os.makedirs(tmp_path / tag)
        tmain(["denoise", "-m", model, "-o", str(tmp_path / tag), "-d", "cpu", mic])
    a = mrc.read(str(tmp_path / "sav" / "mic.mrc"))[0]
    np.testing.assert_array_equal(a, mrc.read(str(tmp_path / "alias" / "mic.mrc"))[0])
    (tmp_path / "images.txt").write_text(f"image_name\tpath\nmic\t{mic}\n")
    (tmp_path / "targets.txt").write_text("image_name\tx_coord\ty_coord\n"
                                          "mic\t20\t30\nmic\t50\t40\n")
    prefix = str(tmp_path / "ft")
    tmain(["train", "-m", state_dict_savs["resnet8_u32"], "--train-images",
           str(tmp_path / "images.txt"), "--train-targets", str(tmp_path / "targets.txt"),
           "-n", "2", "-r", "2", "--num-epochs", "1", "--epoch-size", "1",
           "--minibatch-size", "4", "--save-prefix", prefix, "-d", "cpu",
           "-o", str(tmp_path / "log.txt")])
    spec, params, _ = jfactory.load_picker(prefix + "_epoch1.npz")
    assert spec.arch == "resnet8"
    start = _flat(jfactory.load_picker("resnet8_u32")[1])
    moved = _flat(params)
    assert any(not np.array_equal(moved[k], start[k]) for k in start)
