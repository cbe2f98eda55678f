"""Device-flag resolution and multi-process start-up (port of
topaz_tpu/parallel/devices.py:40-164).

``-d/--device`` values:

  * ``-2`` -> every visible CUDA device, one process driving them all (the
    reference's ``nn.DataParallel``, topaz/commands/denoise3d.py:103,118;
    the JAX package's single-controller mesh). With no CUDA device it
    raises ``DeviceUnavailableError``: the JAX package's ``-2`` runs on the
    CPU backend's devices there, the port never falls back to the CPU;
  * ``-1``, ``N`` and ``cpu`` -> one device, by ``device.resolve_device``'s
    rules (no fallback to device 0 where JAX falls back).

Several hosts: one process a host, joined by ``torch.distributed`` when
the JAX package's variables are set,

    TOPAZ_COORDINATOR=<host:port> TOPAZ_NUM_PROCESSES=<n> \\
    TOPAZ_PROCESS_ID=<i> python -m topaz_tpu_torch <command> ... -d -2

(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``
are read when the TOPAZ_ names are not set). Each process drives its own
devices; at ``train -d -2`` the data-parallel train step (train/trainer.py)
shares batch-norm statistics and all-reduces its gradients across
processes, and at ``-d N`` each process trains alone, as in JAX.

The ``*_mesh_for`` helpers shrink a device list to the mesh a batch can use
and return None below two devices, with the JAX package's rules and notes.
A device list may repeat a device: ``[cpu] * 4`` or ``[cuda:0] * 2`` runs
every sharded path on one device.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import torch

from topaz_tpu_torch.device import DeviceLike, DeviceUnavailableError, resolve_device


def _env(name: str) -> Optional[str]:
    return os.environ.get("TOPAZ_" + name) or os.environ.get("JAX_" + {
        "COORDINATOR": "COORDINATOR_ADDRESS"}.get(name, name))


def maybe_distributed_init() -> bool:
    """Join the process group when the coordinator variables are set:
    ``nccl`` where CUDA is available, else ``gloo``. Idempotent; True when
    running distributed."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    addr = _env("COORDINATOR")
    if not addr:
        return False
    nproc, pid = _env("NUM_PROCESSES"), _env("PROCESS_ID")
    if nproc is None or pid is None:
        raise ValueError("TOPAZ_COORDINATOR is set: set TOPAZ_NUM_PROCESSES and "
                         "TOPAZ_PROCESS_ID too (torch.distributed needs both)")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=int(nproc), rank=int(pid))
    print(f"# distributed runtime: process {dist.get_rank()} of "
          f"{dist.get_world_size()} ({backend})", file=sys.stderr)
    return True


def resolve_devices(device: DeviceLike) -> List[torch.device]:
    """A ``-d`` value as the list of devices to use: every visible CUDA
    device for ``-2``, else the one device ``resolve_device`` gives."""
    maybe_distributed_init()
    if isinstance(device, int) and device == -2:
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "-d -2 (every CUDA device) requested but no CUDA device is "
                "available; pass -d cpu to run on the CPU")
        return [resolve_device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    return [resolve_device(device)]


def data_mesh_for(devices, batch_size: Optional[int] = None, warn: bool = False):
    """A 'data'-axis mesh over ``devices``, shrunk to the largest device
    count that divides ``batch_size``; None when one device remains.
    ``warn`` prints a note when it shrinks: pass True only where
    ``batch_size`` is a user's flag."""
    if devices is None or len(devices) < 2:
        return None
    n = len(devices)
    if batch_size is not None:
        while n > 1 and batch_size % n != 0:
            n -= 1
    if warn and n < len(devices):
        print(f"# note: batch size {batch_size} is not divisible by "
              f"{len(devices)} devices; using {max(n, 1)} "
              f"(pick a batch size that is a multiple of the device count "
              f"to use every device)", file=sys.stderr)
    if n < 2:
        return None

    from topaz_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_data=n, n_space=1, devices=devices[:n])


def hybrid_mesh_for(devices, batch_size: Optional[int] = None, warn: bool = False):
    """A (data, space) mesh that uses every device it can: the batch over
    'data' (the largest device count dividing ``batch_size``) and the
    leftover devices over the image rows on 'space' (the largest power of
    two with data * space <= n). Batch 2 on 8 devices gives 2 x 4, batch 1
    gives 1 x 8. None when fewer than two devices would take part."""
    if devices is None or len(devices) < 2:
        return None
    n = len(devices)
    n_data = n
    if batch_size is not None:
        while n_data > 1 and batch_size % n_data != 0:
            n_data -= 1
    n_space = 1
    while n_data * n_space * 2 <= n:
        n_space *= 2
    if n_data * n_space < 2:
        return None
    if warn and n_data * n_space < n:
        print(f"# note: using a {n_data}x{n_space} (data x space) mesh on "
              f"{n} devices; a batch size dividing the device count would "
              f"use every device", file=sys.stderr)

    from topaz_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_data=n_data, n_space=n_space, devices=devices[: n_data * n_space])


def space_mesh_for(devices):
    """A 'space'-axis mesh over ``devices`` for one image sharded by rows;
    None below two devices."""
    if devices is None or len(devices) < 2:
        return None

    from topaz_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_data=1, n_space=len(devices), devices=devices)
