"""Device selection for the port (the single-device part of
topaz_tpu/parallel/devices.py:70-92; device lists are parallel/devices.py).

Everything runs on a CUDA device unless the caller asks for the CPU by name.
There is no fallback: with no GPU, or a GPU index that does not exist, the
request raises instead of running somewhere else.

CLI ``-d/--device`` values: ``N >= 0`` -> ``cuda:N``, ``-1`` -> the current
CUDA device, ``cpu`` -> the CPU, ``-2`` -> the first of every visible CUDA
device (``parallel.devices.resolve_devices`` gives them all, for the paths
that shard over them).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, int, torch.device]


class DeviceUnavailableError(RuntimeError):
    """A CUDA device was requested that this process cannot use."""


def exact_numerics() -> None:
    """The exact (f32) profile: no TF32 in matrix products or convolutions.
    cuDNN runs f32 convolutions in TF32 by default, which moves scores by
    about 1e-3 and can change picks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Resolve a device request (``"cuda"``, ``"cuda:N"``, ``"cpu"``, a
    ``torch.device`` or a CLI integer) to a ``torch.device``, raising when it
    names a CUDA device that is not there."""
    if isinstance(device, int):
        if device == -2:
            from topaz_tpu_torch.parallel.devices import resolve_devices

            return resolve_devices(-2)[0]
        if device < -1:
            raise ValueError(f"invalid device index {device}")
        device = "cuda" if device == -1 else f"cuda:{device}"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use cuda[:N] or cpu")
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {dev} requested but no CUDA device is available; pass "
            f"device='cpu' (CLI: -d cpu) to run on the CPU")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise DeviceUnavailableError(
            f"device {dev} requested but only {torch.cuda.device_count()} "
            f"CUDA device(s) are visible")
    exact_numerics()
    return dev


def parse_device_flag(value: str) -> DeviceLike:
    """argparse type of ``-d/--device``: ``cpu`` or an integer."""
    if value.strip().lower() == "cpu":
        return "cpu"
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"device must be an integer or 'cpu', got {value!r}") from None

