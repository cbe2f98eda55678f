"""Reference PyTorch checkpoints (``.sav``) read into the JAX package's
parameter trees and written from the port's models (port of
topaz_tpu/models/convert.py).

Reading never runs code from the file. A torch checkpoint is a zip archive
(torch >= 1.6: ``data.pkl`` and raw storages under ``data/``) or the legacy
stream (magic, protocol and sys_info pickles, the main pickle with
persistent storage ids, the key list, then size-prefixed raw storages).
Both carry tensors as pickled rebuild calls over raw little-endian
storages, so a restricted unpickler and a storage decoder read them: only
the containers, torch's tensor rebuild functions and numpy's array
reconstruction are resolved; torch, topaz and torchvision classes (the
reference's whole pickled modules) become inert stubs that keep their
attributes and their class name; everything else is refused. A file the
reader refuses raises ``SavFormatError`` naming the reason: there is no
fallback to ``torch.load``, which would run a crafted pickle.

Trees hold HWIO (DHWIO) kernels, as the JAX package's ``.npz`` checkpoints
do; the factories turn them into the port's OIHW modules.

Writing: ``write_sav`` writes a zip-format state dict with ``zipfile`` and
``pickle``, the tensors as ``torch._utils._rebuild_tensor_v2`` over
``torch.FloatStorage``, so ``torch.load(..., weights_only=True)`` and the
JAX package's ``load_sav`` both read it.
"""

from __future__ import annotations

import io
import os
import pickle
import re
import struct
import zipfile
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np


class SavFormatError(ValueError):
    """A ``.sav`` file that the restricted reader does not read."""


def _to_hwio(w: np.ndarray) -> np.ndarray:
    """OI<spatial> -> <spatial>IO."""
    nd = w.ndim
    return np.ascontiguousarray(np.transpose(w, tuple(range(2, nd)) + (1, 0)))


def _from_hwio(w: np.ndarray) -> np.ndarray:
    """<spatial>IO -> OI<spatial> (inverse of _to_hwio)."""
    nd = np.ndim(w)
    return np.ascontiguousarray(np.transpose(np.asarray(w), (nd - 1, nd - 2)
                                             + tuple(range(nd - 2))))


# -- reading ------------------------------------------------------------------

_STORAGE_DTYPES = {
    "FloatStorage": np.dtype("<f4"),
    "DoubleStorage": np.dtype("<f8"),
    "HalfStorage": np.dtype("<f2"),
    "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"),
    "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("i1"),
    "ByteStorage": np.dtype("u1"),
    "BoolStorage": np.dtype("?"),
    "BFloat16Storage": np.dtype("<u2"),  # decoded to f32 when attached
}

_LEGACY_MAGIC = 0x1950A86A20F9469CFC6C


class _StorageRef:
    """A torch storage; its raw bytes attach after unpickling (legacy) or
    when it is first named (zip)."""

    def __init__(self, dtype_name: str):
        self.dtype_name = dtype_name
        self.array = None

    def attach(self, raw: bytes):
        arr = np.frombuffer(raw, dtype=_STORAGE_DTYPES[self.dtype_name])
        if self.dtype_name == "BFloat16Storage":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        self.array = arr


class _StorageView:
    """A legacy storage view: (root storage, element offset, numel)."""

    def __init__(self, root: _StorageRef, offset: int, numel: int):
        self.root, self.offset, self.numel = root, offset, numel

    @property
    def array(self):
        return self.root.array[self.offset:self.offset + self.numel]


class _LazyTensor:
    """A tensor made an array once its storage's bytes are there."""

    def __init__(self, storage, offset, size, stride):
        self.storage, self.offset = storage, offset
        self.size, self.stride = tuple(size), tuple(stride)

    def materialize(self) -> np.ndarray:
        arr = self.storage.array
        if arr is None:
            raise SavFormatError("storage data missing for a tensor")
        if not self.size:
            return arr[self.offset:self.offset + 1].reshape(()).copy()
        end = self.offset + 1 + sum((n - 1) * s for n, s in zip(self.size, self.stride))
        if min(self.size) > 0 and (self.offset < 0 or min(self.stride) < 0
                                   or end > len(arr)):
            raise SavFormatError(f"tensor of size {self.size} and stride {self.stride} "
                                 f"at offset {self.offset} overruns its storage of "
                                 f"{len(arr)} elements")
        out = np.lib.stride_tricks.as_strided(
            arr[self.offset:], shape=self.size,
            strides=tuple(s * arr.itemsize for s in self.stride))
        return np.ascontiguousarray(out)


def _rebuild_tensor(storage, offset, size, stride, *_args):
    return _LazyTensor(storage, offset, size, stride)


def _rebuild_parameter(data, *_args):
    return data


class _ModuleStub:
    """Inert stand-in for a pickled class (nn.Module subclasses and the
    like): keeps the pickled attributes and answers what the converters
    ask of an nn.Module (attributes through _modules, _parameters and
    _buffers; Sequential iteration; state_dict)."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        parts = state if isinstance(state, (tuple, list)) else [state]
        for part in parts:
            if isinstance(part, dict):
                self.__dict__.update(part)

    def __getattr__(self, name):
        for container in ("_parameters", "_buffers", "_modules"):
            d = self.__dict__.get(container)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(name)

    def __iter__(self):
        return iter(self.__dict__.get("_modules", {}).values())

    def __len__(self):
        return len(self.__dict__.get("_modules", {}))

    def state_dict(self) -> Dict[str, np.ndarray]:
        out = {}

        def walk(mod, prefix):
            d = mod.__dict__ if isinstance(mod, _ModuleStub) else {}
            for group in ("_parameters", "_buffers"):
                for k, v in (d.get(group) or {}).items():
                    if v is not None:
                        out[prefix + k] = v
            for k, sub in (d.get("_modules") or {}).items():
                if sub is not None:
                    walk(sub, prefix + k + ".")

        walk(self, "")
        return out


def _restricted_unpickler(fh, persistent_load, stub_cache):
    np_multiarray = getattr(np, "_core", getattr(np, "core", np)).multiarray
    safe = {
        ("collections", "OrderedDict"): OrderedDict,
        ("builtins", "set"): set,
        ("builtins", "frozenset"): frozenset,
        ("__builtin__", "set"): set,
        ("__builtin__", "frozenset"): frozenset,
        ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor,
        ("torch._utils", "_rebuild_tensor"): _rebuild_tensor,
        ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
        ("torch._utils", "_rebuild_parameter_with_state"): _rebuild_parameter,
        ("torch", "Size"): tuple,
        ("torch.serialization", "_get_layout"): lambda name: name,
        ("numpy", "ndarray"): np.ndarray,
        ("numpy", "dtype"): np.dtype,
    }
    for np_mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        safe[(np_mod, "_reconstruct")] = np_multiarray._reconstruct
        safe[(np_mod, "scalar")] = np_multiarray.scalar

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if (module, name) in safe:
                return safe[(module, name)]
            if module == "torch" and name in _STORAGE_DTYPES:
                return stub_cache.setdefault(("storage", name),
                                             type(name, (), {"_dtype_name": name}))
            # torch, topaz and torchvision classes become stubs that keep
            # their class name (infer_picker_config reads it)
            if module.split(".")[0] in ("torch", "topaz", "torchvision"):
                return stub_cache.setdefault(
                    (module, name), type(name, (_ModuleStub,), {"_source": f"{module}.{name}"}))
            raise pickle.UnpicklingError(f"refusing to unpickle {module}.{name}")

    up = Unpickler(fh)
    up.persistent_load = persistent_load
    return up


def _materialize(obj, memo=None):
    """The unpickled graph with every _LazyTensor replaced by its array."""
    memo = {} if memo is None else memo
    oid = id(obj)
    if oid in memo:
        return memo[oid]
    if isinstance(obj, _LazyTensor):
        memo[oid] = obj.materialize()
        return memo[oid]
    if isinstance(obj, dict):
        memo[oid] = obj
        for k in list(obj):
            obj[k] = _materialize(obj[k], memo)
        return obj
    if isinstance(obj, list):
        memo[oid] = obj
        obj[:] = [_materialize(v, memo) for v in obj]
        return obj
    if isinstance(obj, tuple):
        memo[oid] = tuple(_materialize(v, memo) for v in obj)
        return memo[oid]
    if isinstance(obj, _ModuleStub):
        memo[oid] = obj
        obj.__dict__.update({k: _materialize(v, memo) for k, v in obj.__dict__.items()})
    return obj


def _storage_pid(pid):
    if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
        raise SavFormatError(f"unknown persistent id {pid!r}")
    storage_type = pid[1]
    if not hasattr(storage_type, "_dtype_name"):
        raise SavFormatError(f"unknown storage type {storage_type!r}")
    return pid


def _load_sav_zip(fh):
    stub_cache: Dict = {}
    with zipfile.ZipFile(fh) as zf:
        pkls = [n for n in zf.namelist() if n.endswith("/data.pkl") or n == "data.pkl"]
        if len(pkls) != 1:
            raise SavFormatError(f"a zip checkpoint holds one data.pkl; found {pkls}")
        prefix = pkls[0][:-len("data.pkl")]
        storages: Dict[str, _StorageRef] = {}

        def persistent_load(pid):
            storage_type, key = _storage_pid(pid)[1:3]
            if key not in storages:
                ref = _StorageRef(storage_type._dtype_name)
                ref.attach(zf.read(f"{prefix}data/{key}"))
                storages[key] = ref
            return storages[key]

        with zf.open(pkls[0]) as raw:
            obj = _restricted_unpickler(io.BytesIO(raw.read()), persistent_load,
                                        stub_cache).load()
    return _materialize(obj)


def _load_sav_legacy(fh):
    stub_cache: Dict = {}
    storages: Dict[str, _StorageRef] = {}

    def persistent_load(pid):
        if isinstance(pid, tuple) and pid and pid[0] == "module":
            # a legacy whole-module pickle names each module's class; the
            # class is already a stub from find_class
            return pid[1]
        storage_type, root_key = _storage_pid(pid)[1:3]
        view_metadata = pid[5] if len(pid) > 5 else None
        root = storages.setdefault(root_key, _StorageRef(storage_type._dtype_name))
        if view_metadata:
            _view_key, offset, view_numel = view_metadata[:3]
            return _StorageView(root, offset, view_numel)
        return root

    def load():
        return _restricted_unpickler(fh, persistent_load, stub_cache).load()

    # the preamble pickles go through the restricted reader too: a plain
    # pickle.load would run a crafted payload before the magic is checked
    if load() != _LEGACY_MAGIC:
        raise SavFormatError("not a torch checkpoint (bad magic number)")
    load()  # protocol version
    load()  # sys_info
    obj = load()
    for key in load():
        (numel,) = struct.unpack("<q", fh.read(8))
        if key not in storages:
            raise SavFormatError(f"storage {key!r} is not named by the pickle")
        ref = storages[key]
        ref.attach(fh.read(numel * _STORAGE_DTYPES[ref.dtype_name].itemsize))
    return _materialize(obj)


def load_sav(path_or_file):
    """Read a reference ``.sav`` checkpoint (state dict or whole pickled
    module; zip or legacy format) with the restricted reader: arrays in
    place of tensors, stubs in place of modules. A path or a binary file
    object read from where it stands. Raises ``SavFormatError`` with the
    reason for a file it does not read; nothing is unpickled freely."""
    if hasattr(path_or_file, "read"):
        return _load_from(path_or_file, repr(path_or_file))
    with open(path_or_file, "rb") as fh:
        return _load_from(fh, path_or_file)


def _load_from(fh, where: str):
    pos = fh.tell()
    is_zip = zipfile.is_zipfile(fh)
    fh.seek(pos)
    try:
        return _load_sav_zip(fh) if is_zip else _load_sav_legacy(fh)
    except SavFormatError as e:
        raise SavFormatError(f"{where}: {e}") from e
    except (pickle.UnpicklingError, EOFError, ValueError, KeyError, TypeError,
            AttributeError, IndexError, struct.error, zipfile.BadZipFile) as e:
        raise SavFormatError(f"{where}: the restricted .sav reader does not read this "
                             f"file ({type(e).__name__}: {e}); .sav files are never "
                             f"unpickled freely") from e


def _state_dict_of(obj) -> Dict[str, np.ndarray]:
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    if not isinstance(sd, dict):
        raise SavFormatError(f"the checkpoint holds a {type(sd).__name__}, not a state dict "
                             f"or a module")
    return {k: np.asarray(v) for k, v in sd.items()}


def params_tree_from_state_dict(sd: Dict[str, np.ndarray], allow_bn: bool = False) -> Dict:
    """A torch state dict as a nested tree of 'w' (HWIO), 'b' and 'scale'
    leaves. A 1-D 'weight' is a batchnorm scale, which a module without
    batchnorm must refuse (``allow_bn=False``) rather than drop."""
    params: Dict = {}
    for key, val in sd.items():
        parts = key.split(".")
        leaf = parts[-1]
        if leaf not in ("weight", "bias"):
            continue
        val = np.asarray(val)
        if leaf == "weight" and val.ndim == 1 and not allow_bn:
            raise ValueError(
                f"state dict entry {key!r} looks like batch-norm, which this module's "
                f"apply path does not implement; conversion would silently drop the "
                f"normalization")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if leaf == "weight" and val.ndim > 1:
            node["w"] = _to_hwio(val)
        elif leaf == "weight":
            node["scale"] = val
        else:
            node["b"] = val
    return params


def picker_params_from_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """A LinearClassifier state dict as (params, state) trees.

    Reference keys (topaz/model/classifier.py, features/*):
      features.features.{i}.conv.{weight,bias}         BasicConv
      features.features.{i}.{conv0,conv1,proj}.*       ResidA
      features.features.{i}.bn{,0,1}.{weight,bias,running_mean,running_var}
      features.features.{i}.act.weight                 PReLU slope
      classifier.{weight,bias}                         1x1 head
    """
    feat_params: Dict[str, Dict] = {}
    feat_state: Dict[str, Dict] = {}
    params: Dict = {"features": feat_params}
    pat = re.compile(r"^features\.features\.(\d+)\.(.+)$")
    for key, val in sd.items():
        if key in ("classifier.weight", "classifier.bias"):
            leaf = "w" if key.endswith("weight") else "b"
            params.setdefault("classifier", {})[leaf] = _to_hwio(val) if leaf == "w" else val
            continue
        m = pat.match(key)
        if m is None:
            continue
        lp = feat_params.setdefault(m.group(1), {})
        ls = feat_state.setdefault(m.group(1), {})
        sub, _, leaf = m.group(2).partition(".")
        if sub in ("conv", "conv0", "conv1", "proj") and leaf == "weight":
            lp[f"{sub}_w"] = _to_hwio(val)
        elif sub in ("conv", "conv0", "conv1") and leaf == "bias":
            lp[f"{sub}_b"] = val
        elif sub.startswith("bn"):
            if leaf in ("weight", "bias"):
                lp.setdefault(sub, {})["scale" if leaf == "weight" else "bias"] = val
            elif leaf in ("running_mean", "running_var"):
                ls.setdefault(sub, {})["mean" if leaf == "running_mean" else "var"] = val
        elif sub == "act" and leaf == "weight":
            lp["prelu"] = np.asarray(val).reshape(())
    for d in (feat_params, feat_state):
        for k in [k for k, v in d.items() if not v]:
            del d[k]
    return params, {"features": feat_state}


def infer_picker_config(sd: Dict[str, np.ndarray],
                        module_names: Optional[Dict[int, str]] = None) -> Dict:
    """(arch, units, bn[, pooling]) of a reference picker state dict.

    ``module_names`` maps a Sequential index to its module's class name,
    read from a whole-module pickle: a Sequential slot without parameters
    is a MaxPool or a Dropout, and only the class name tells which. The
    port's layer specs hold pools and dropouts in the reference's slots, so
    the indices line up."""
    if "features.features.0.conv.weight" not in sd:
        raise ValueError(
            "this .sav uses the reference BasicConv (conv31/63/127) module layout, which "
            "this converter does not support yet; train the conv architectures natively "
            "('train --model conv31 ...') instead of converting a reference checkpoint")
    idxs = sorted({int(m.group(1)) for k in sd
                   if (m := re.match(r"^features\.features\.(\d+)\.", k))})
    gaps = set(range(max(idxs) + 1)) - set(idxs)
    pooling = None
    if gaps:
        if module_names is None:
            raise ValueError(
                "this picker state dict has Sequential slots without parameters (MaxPool "
                "or Dropout), which change the architecture's geometry; convert from the "
                "whole-module .sav (the reference's usual save format) so that the module "
                "types can be read")
        if any("MaxPool" in module_names.get(i, "") for i in gaps):
            pooling = "max"
    w0 = sd["features.features.0.conv.weight"]
    resid = any(f"features.features.{i}.conv0.weight" in sd for i in idxs)
    if resid and w0.shape[-1] == 7:
        arch = "resnet8" if len(idxs) == 5 else "resnet16"
    else:
        arch = "resnet6"
    out = {"arch": arch, "units": int(w0.shape[0]), "bn": any(".bn" in k for k in sd)}
    if pooling:
        out["pooling"] = pooling
    return out


def convert_picker_sav(path: str) -> Tuple[Dict, Dict, Dict]:
    """A reference ``.sav`` picker as (meta, params, state)."""
    obj = load_sav(path)
    sd = _state_dict_of(obj)
    module_names = None
    try:  # a whole-module pickle names the Sequential's module types
        module_names = {i: type(m).__name__ for i, m in enumerate(obj.features.features)}
    except AttributeError:
        pass
    meta = infer_picker_config(sd, module_names=module_names)
    meta["dims"] = 2
    params, state = picker_params_from_state_dict(sd)
    return meta, params, state


def convert_denoiser_sav(path: str) -> Tuple[Dict, Dict]:
    """A reference ``.sav`` denoiser as (meta, params); the pickled
    module's class name tells UDenoiseNet3 from UDenoiseNet
    (topaz_tpu/models/denoise_factory.py:34-45)."""
    from topaz_tpu_torch.models.denoise import denoiser_params_from_state_dict, infer_denoiser_arch

    obj = load_sav(path)
    sd = _state_dict_of(obj)
    meta = infer_denoiser_arch(sd, class_name=type(obj).__name__)
    return meta, denoiser_params_from_state_dict(sd)


# -- writing ------------------------------------------------------------------

class _StorageOut:
    """A storage to write; its persistent id names it."""

    def __init__(self, storage_cls, key: str, numel: int):
        self.storage_cls, self.key, self.numel = storage_cls, key, numel


class _TensorOut:
    """Pickles as torch._utils._rebuild_tensor_v2(storage, 0, size,
    stride, False, OrderedDict())."""

    def __init__(self, rebuild, storage: _StorageOut, shape, stride):
        self._rebuild, self._storage = rebuild, storage
        self._shape = tuple(int(s) for s in shape)
        self._stride = tuple(int(s) for s in stride)

    def __reduce__(self):
        return (self._rebuild, (self._storage, 0, self._shape, self._stride, False,
                                OrderedDict()))


def write_sav(path: str, state_dict: Dict[str, np.ndarray]) -> None:
    """Write ``state_dict`` (name -> array, stored as float32) as a torch
    zip-format ``.sav`` that ``torch.load(path, weights_only=True)`` reads
    (topaz_tpu/models/convert.py:611-656)."""
    import torch

    out, storages = OrderedDict(), []
    for i, (name, arr) in enumerate(state_dict.items()):
        arr = np.ascontiguousarray(np.asarray(arr, dtype=np.float32))
        stride = [int(np.prod(arr.shape[k + 1:])) for k in range(arr.ndim)]
        storage = _StorageOut(torch.FloatStorage, str(i), arr.size)
        storages.append((storage, arr))
        out[name] = _TensorOut(torch._utils._rebuild_tensor_v2, storage, arr.shape, stride)

    buf = io.BytesIO()
    pickler = pickle.Pickler(buf, protocol=2)

    def persistent_id(obj):
        if isinstance(obj, _StorageOut):
            return ("storage", obj.storage_cls, obj.key, "cpu", obj.numel)
        return None

    pickler.persistent_id = persistent_id
    pickler.dump(out)
    base = os.path.splitext(os.path.basename(path))[0]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(f"{base}/data.pkl", buf.getvalue())
        for storage, arr in storages:
            zf.writestr(f"{base}/data/{storage.key}", arr.tobytes())
        zf.writestr(f"{base}/version", "3\n")


def _basic_conv_state_dict(spec, params: Dict, state: Dict) -> Dict[str, np.ndarray]:
    """conv31/63/127 in the reference BasicConv layout
    (topaz/model/features/basic.py:15-76): raw Conv, BatchNorm and
    activation modules in one Sequential, so a conv group spans several
    slots (conv, [bn], act, [pool], [dropout])."""
    from topaz_tpu_torch.models.layers import ConvSpec, DropoutSpec, PoolSpec

    sd: Dict[str, np.ndarray] = {}
    feat_params = params.get("features", {})
    feat_state = (state or {}).get("features", {})
    slot = 0
    for idx, lspec in enumerate(spec.features):
        lp, ls = feat_params.get(str(idx), {}), feat_state.get(str(idx), {})
        if isinstance(lspec, (PoolSpec, DropoutSpec)):
            slot += 1
            continue
        if not isinstance(lspec, ConvSpec):
            raise ValueError(f"unexpected layer {type(lspec).__name__} in a conv arch")
        pre = f"features.features.{slot}."
        sd[pre + "weight"] = _from_hwio(lp["conv_w"])
        if "conv_b" in lp:
            sd[pre + "bias"] = np.asarray(lp["conv_b"])
        slot += 1
        if lspec.bn:
            pre = f"features.features.{slot}."
            sd[pre + "weight"] = np.asarray(lp["bn"]["scale"])
            sd[pre + "bias"] = np.asarray(lp["bn"]["bias"])
            sd[pre + "running_mean"] = np.asarray(ls["bn"]["mean"])
            sd[pre + "running_var"] = np.asarray(ls["bn"]["var"])
            sd[pre + "num_batches_tracked"] = np.zeros((), np.int64)
            slot += 1
        if "prelu" in lp:  # nn.PReLU() holds one weight; ReLU none
            sd[f"features.features.{slot}.weight"] = np.asarray(lp["prelu"]).reshape(1)
        slot += 1
    if "classifier" in params:
        sd["classifier.weight"] = _from_hwio(params["classifier"]["w"])
        sd["classifier.bias"] = np.asarray(params["classifier"]["b"])
    return sd


def picker_state_dict(spec, params: Dict, state: Dict) -> Dict[str, np.ndarray]:
    """Picker trees in the reference LinearClassifier's state-dict layout,
    the inverse of ``picker_params_from_state_dict`` (conv archs in
    BasicConv's, ``_basic_conv_state_dict``)."""
    if spec.arch.startswith("conv"):
        return _basic_conv_state_dict(spec, params, state)
    sd: Dict[str, np.ndarray] = {}
    feat_state = (state or {}).get("features", {})
    for idx, lp in params.get("features", {}).items():
        pre = f"features.features.{idx}."
        for ours, theirs, is_conv in (
                ("conv_w", "conv.weight", True), ("conv_b", "conv.bias", False),
                ("conv0_w", "conv0.weight", True), ("conv0_b", "conv0.bias", False),
                ("conv1_w", "conv1.weight", True), ("conv1_b", "conv1.bias", False),
                ("proj_w", "proj.weight", True)):
            if ours in lp:
                sd[pre + theirs] = _from_hwio(lp[ours]) if is_conv else np.asarray(lp[ours])
        if "prelu" in lp:
            sd[pre + "act.weight"] = np.asarray(lp["prelu"]).reshape(1)
        for sub, d in lp.items():
            if isinstance(d, dict) and sub.startswith("bn"):
                for ours, theirs in (("scale", "weight"), ("bias", "bias")):
                    if ours in d:
                        sd[f"{pre}{sub}.{theirs}"] = np.asarray(d[ours])
        for sub, d in feat_state.get(idx, {}).items():
            if isinstance(d, dict) and sub.startswith("bn"):
                for ours, theirs in (("mean", "running_mean"), ("var", "running_var")):
                    if ours in d:
                        sd[f"{pre}{sub}.{theirs}"] = np.asarray(d[ours])
                sd[f"{pre}{sub}.num_batches_tracked"] = np.zeros((), np.int64)
    if "classifier" in params:
        sd["classifier.weight"] = _from_hwio(params["classifier"]["w"])
        sd["classifier.bias"] = np.asarray(params["classifier"]["b"])
    return sd


def _reference(import_it):
    """The reference ``topaz`` package's objects that a whole-module
    export pickles."""
    try:
        return import_it()
    except ImportError as e:
        raise ImportError(
            "whole-module export pickles a reference nn.Module, so the reference 'topaz' "
            "package must be importable at export time (pip install topaz-em, or add its "
            "checkout to PYTHONPATH); use the default state-dict export otherwise") from e


def _save_module(path: str, module, sd: Dict[str, np.ndarray]) -> None:
    import torch

    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in sd.items()})
    module.eval()
    torch.save(module, path)


def export_picker_sav(path: str, model: str, whole_module: bool = False) -> None:
    """Export a picker (alias or ``.npz`` checkpoint) as a reference-layout
    ``.sav`` (topaz_tpu/models/convert.py:757-814).

    Default: a state dict, which ``torch.load(path, weights_only=True)``
    and the reference's ``load_state_dict`` read. ``whole_module=True``: a
    pickled reference nn.Module, the reference CLI's ``--model`` format,
    which needs the reference ``topaz`` package."""
    from topaz_tpu_torch.models.factory import load_picker, picker_to_numpy

    picker = load_picker(model, device="cpu")
    params, state = picker_to_numpy(picker)
    spec = picker.spec
    sd = picker_state_dict(spec, params, state)
    if not whole_module:
        write_sav(path, sd)
        return

    def imports():
        from topaz.model.classifier import LinearClassifier
        from topaz.model.factory import get_feature_extractor
        return LinearClassifier, get_feature_extractor

    LinearClassifier, get_feature_extractor = _reference(imports)
    cfg = dict(spec.config or [])
    kwargs = {"units": int(cfg.get("units", 32)), "dropout": float(cfg.get("dropout", 0.0)),
              "bn": bool(cfg.get("bn", False))}
    if cfg.get("pooling"):
        kwargs["pooling"] = cfg["pooling"]
    if spec.arch.startswith("conv") and cfg.get("unit_scaling"):
        kwargs["unit_scaling"] = int(cfg["unit_scaling"])
    act = cfg.get("activation")
    if act is not None and act != ("prelu" if spec.arch.startswith("conv") else "relu"):
        from torch import nn

        kwargs["activation"] = {"relu": nn.ReLU, "prelu": nn.PReLU}[act]
    _save_module(path, LinearClassifier(get_feature_extractor(spec.arch, **kwargs)), sd)


def state_dict_from_params_tree(params: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of ``params_tree_from_state_dict``: 'w', 'b' and 'scale'
    leaves as torch dotted names, kernels back to OI<spatial>."""
    sd: Dict[str, np.ndarray] = {}
    for key, val in params.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            sd.update(state_dict_from_params_tree(val, name))
        elif key in ("w", "scale"):
            sd[f"{prefix}.weight" if prefix else "weight"] = (
                _from_hwio(val) if key == "w" else np.asarray(val))
        elif key == "b":
            sd[f"{prefix}.bias" if prefix else "bias"] = np.asarray(val)
        else:
            sd[name] = np.asarray(val)
    return sd


def export_denoiser_sav(path: str, model: str, whole_module: bool = False) -> None:
    """Export a denoiser (alias, ``.npz`` or ``.sav``) as a reference-layout
    ``.sav`` (topaz_tpu/models/convert.py:837-907): a state dict by
    default, or a pickled reference module (``whole_module=True``, needs
    the reference ``topaz`` package)."""
    import warnings

    from topaz_tpu_torch.models.denoise_factory import denoiser_to_numpy, load_denoiser

    meta, params = denoiser_to_numpy(load_denoiser(model, device="cpu"))
    sd = state_dict_from_params_tree(params)
    if not whole_module:
        if meta.get("arch") == "unet3":
            warnings.warn(
                "exporting a unet3 (noise-residual) denoiser as a state-dict: the reference "
                "must load it as UDenoiseNet3, which its state-dict loader cannot express; "
                "use whole_module=True or pass the arch explicitly on the reference side")
        write_sav(path, sd)
        return

    def imports():
        from topaz.denoising import models
        return models

    ref_models = _reference(imports)
    arch, dims = meta.get("arch"), int(meta.get("dims", 2))
    nf, bw, tw = int(meta.get("nf", 48)), int(meta.get("base_width", 11)), int(
        meta.get("top_width", 3))
    if dims == 3:
        if arch != "unet":
            raise ValueError(f"no reference 3D module for denoiser arch {arch!r}")
        module = ref_models.UDenoiseNet3D(nf=nf, base_width=bw, top_width=tw)
    elif arch == "unet":
        module = ref_models.UDenoiseNet(nf=nf, base_width=bw, top_width=tw)
    elif arch == "unet-small":
        module = ref_models.UDenoiseNetSmall(nf=nf, width=bw, top_width=tw)
    elif arch == "unet2":
        module = ref_models.UDenoiseNet2(nf=nf)
    elif arch == "unet3":
        module = ref_models.UDenoiseNet3()
    elif arch == "fcnet":
        module = ref_models.DenoiseNet2(nf, width=bw)
    elif arch == "affine":
        module = ref_models.AffineDenoise()
    else:
        raise ValueError(f"unknown denoiser arch {arch!r}")
    _save_module(path, module, sd)
