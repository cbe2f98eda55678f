"""Scale-out over several devices driven by one process (port of
topaz_tpu/parallel/mesh.py:26-237).

A ``Mesh`` is a (data, space) grid of ``torch.device``s, as the JAX
package's is of JAX devices:

  * ``data`` splits a batch (micrographs, frames, patches, training crops):
    each data row's first device runs its share on its own copy of the
    weights, and the outputs are gathered on the mesh's first device;
  * ``space`` splits one large image by rows (tomograms by z-slabs): each
    shard gets its neighbours' edge rows as a halo (zeros at the image's
    outer edges), runs on its device and keeps its own rows.

Where the JAX package's ``jit_sharded_args`` lets XLA split a program's
arguments, the port's callers split through ``split_apply`` and the
functions below. Every shard is issued from a thread of its own
(``run_each``), so a shard that waits on its device (the NMS rounds' host
checks) holds back no other device. A grid may repeat a device (``[cpu] *
4``, ``[cuda:0] * 2``), which runs every sharded path on one device.
Across processes only the data-parallel train step talks
(``torch.distributed``, see parallel/devices.py); each process's mesh holds
its own devices.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Mesh:
    """A (data, space) grid of devices; ``shape`` is {"data": n, "space": m}."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"data": devices.shape[0], "space": devices.shape[1]}

    @property
    def data_devices(self) -> List[torch.device]:
        """The first device of each data row."""
        return list(self.devices[:, 0])

    @property
    def space_devices(self) -> List[torch.device]:
        """The devices of the first data row."""
        return list(self.devices[0])


def make_mesh(n_data: Optional[int] = None, n_space: int = 1, devices=None) -> Mesh:
    """A (data, space) mesh over ``devices`` (default: every CUDA device)."""
    if devices is None:
        from topaz_tpu_torch.parallel.devices import resolve_devices

        devices = resolve_devices(-2)
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_space
    if n_data * n_space > len(devices) or n_data < 1:
        raise ValueError(f"a {n_data}x{n_space} mesh needs {n_data * n_space} devices, "
                         f"got {len(devices)}")
    grid = np.empty((n_data, n_space), dtype=object)
    for i, d in enumerate(devices[: n_data * n_space]):
        grid[i // n_space, i % n_space] = d
    return Mesh(grid)


def replicas(module: nn.Module, devices: Sequence[torch.device],
             cache: Optional[Dict] = None) -> List[nn.Module]:
    """``module`` for the first device (moved there) and a copy of it on
    each other position of ``devices``, also where a device repeats. With a
    ``cache`` the copies are made once; the caller keeps them in step."""
    devices = list(devices)
    key = (id(module), tuple(str(d) for d in devices))
    if cache is not None and key in cache:
        return cache[key]
    out = [module.to(devices[0])] + [copy.deepcopy(module).to(d) for d in devices[1:]]
    if cache is not None:
        cache[key] = out
    return out


class StatSync:
    """Sums that the shards of one step share: ``allsum(i, t)``, called by
    each of ``parties`` shards (one thread each) with a tensor of one
    shape, returns the sum over the shards, in shard order, on shard i's
    device, and with ``dist`` also over every process (a differentiable
    ``all_reduce``, made once a process, by shard 0). Gradients flow back
    into every shard's part. Batch norm uses it (models/layers.py) for the
    whole batch's statistics."""

    def __init__(self, parties: int, dist=None):
        self.parties, self.dist = parties, dist
        self.barrier = threading.Barrier(parties)
        self.slots: List[Optional[torch.Tensor]] = [None] * parties
        self.total: Optional[torch.Tensor] = None

    def allsum(self, i: int, t: torch.Tensor) -> torch.Tensor:
        self.slots[i] = t
        self.barrier.wait()
        if i == 0:
            total = t
            for s in self.slots[1:]:
                total = total + s.to(t.device)
            if self.dist is not None:
                from torch.distributed.nn.functional import all_reduce

                total = all_reduce(total)
            self.total = total
        self.barrier.wait()  # no shard writes its next slot before shard 0 has read them
        return self.total.to(t.device)

    @contextlib.contextmanager
    def party(self, i: int):
        """Within this block the calling thread is shard ``i``; an error
        breaks the barrier, so the other shards raise instead of waiting."""
        _party.current = (self, i)
        try:
            yield
        except BaseException:
            self.barrier.abort()
            raise
        finally:
            _party.current = None


_party = threading.local()


def shared_sum():
    """The running shard's ``allsum`` (``t -> t`` summed over the shards of
    its step), or None outside a ``StatSync`` party."""
    current = getattr(_party, "current", None)
    if current is None:
        return None
    sync, i = current
    return lambda t: sync.allsum(i, t)


# the shards' threads, kept between calls: a thread's first CUDA work sets up
# its own library handles, which cost milliseconds a call when each call
# started new threads. Calls nest (a pipeline's data rows each score over
# their space devices), so the pool is far larger than any mesh.
_POOL = ThreadPoolExecutor(max_workers=256, thread_name_prefix="topaz-shard")


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def run_each(fn: Callable, devices: Sequence[torch.device], chunks: Sequence[Sequence],
             sync: Optional[StatSync] = None) -> list:
    """``fn(i, devices[i], *chunks[i])`` for every i, the chunks moved to
    ``devices[i]`` first; the results in order. Each call runs on a thread
    of its own (inline when there is one), with the caller's grad and
    inference modes and its device current, and as shard i of ``sync``
    when one is given. The first error is raised."""
    grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()

    def call(i):
        dev = devices[i]
        with contextlib.ExitStack() as stack:
            if sync is not None:
                stack.enter_context(sync.party(i))
            if len(devices) > 1:
                stack.enter_context(torch.inference_mode(inference))
                stack.enter_context(torch.set_grad_enabled(grad))
                stack.enter_context(_on(dev))
            return fn(i, dev, *(c.to(dev) for c in chunks[i]))

    if len(devices) == 1:
        return [call(0)]
    futures = [_POOL.submit(call, i) for i in range(len(devices))]
    wait(futures)
    errors = [f.exception() for f in futures if f.exception() is not None]
    if errors:  # a broken barrier is the other shards' echo of the first error
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return [f.result() for f in futures]


def split_apply(fn: Callable, devices: Sequence[torch.device], *batches: torch.Tensor,
                out_device=None, sync_stats: bool = False, dist=None):
    """``fn(i, device, *chunks)`` for each of ``devices`` (a mesh's
    ``data_devices``, or one device) on its share of every batch (split
    along dim 0, in order; no more shares than rows), through ``run_each``,
    with the outputs (a tensor, a tuple of tensors or None entries)
    concatenated on ``out_device`` (default: the first device).
    ``sync_stats`` makes the shards one batch for batch norm (``StatSync``,
    over processes too with ``dist``); with one shard and no ``dist`` there
    is nothing to share."""
    devices = list(devices)
    out_device = devices[0] if out_device is None else out_device
    devices = devices[:max(1, min(len(devices), batches[0].shape[0]))]
    shares = [torch.tensor_split(b, len(devices)) for b in batches]
    sync = (StatSync(len(devices), dist)
            if sync_stats and (len(devices) > 1 or dist is not None) else None)
    outs = run_each(fn, devices, [[s[i] for s in shares] for i in range(len(devices))], sync)

    def gather(parts):
        if parts[0] is None:
            return None
        parts = [p.to(out_device) for p in parts]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    if isinstance(outs[0], torch.Tensor):
        return gather(outs)
    return tuple(gather(parts) for parts in zip(*outs))


def sync_replicas(module: nn.Module, reps: Sequence[nn.Module]) -> None:
    """Copy ``module``'s weights and buffers into its copies ``reps[1:]``."""
    with torch.no_grad():
        for rep in reps[1:]:
            for dst, src in zip(rep.state_dict().values(), module.state_dict().values()):
                dst.copy_(src)


def summed_grads(loss: torch.Tensor, params: Sequence[torch.Tensor],
                 reps: Sequence[nn.Module]) -> List[torch.Tensor]:
    """The gradient of ``loss`` for ``params``, whose first entries are
    ``reps[0]``'s parameters, with each copy's gradient (``reps[1:]``, on
    their devices) added into its original's, on the original's device."""
    params = list(params)
    copies = [list(rep.parameters()) for rep in reps[1:]]
    grads = torch.autograd.grad(loss, params + [p for c in copies for p in c],
                                allow_unused=True)
    out = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    k = len(params)
    for c in copies:
        for j, g in enumerate(grads[k:k + len(c)]):
            if g is not None:
                out[j] = out[j] + g.to(out[j].device)
        k += len(c)
    return out


# ---------------------------------------------------------------------------
# batched data-parallel scoring (mesh.py:73-94)
# ---------------------------------------------------------------------------

def make_batched_scorer(model: nn.Module, mesh: Mesh):
    """Dense scoring of a (B, H, W) batch split over the data axis, each
    device with its own copy of the picker; the (B, H, W) score maps are
    gathered on the first device."""
    reps = replicas(model, mesh.data_devices)

    @torch.inference_mode()
    def score(batch) -> torch.Tensor:
        batch = torch.as_tensor(batch, dtype=torch.float32)
        return split_apply(lambda i, dev, xb: reps[i](xb), mesh.data_devices, batch)

    return score


# ---------------------------------------------------------------------------
# row (space) sharding with halos (mesh.py:96-226)
# ---------------------------------------------------------------------------

def _halo_blocks(x: torch.Tensor, n: int, halo: int, what: str) -> List[List[torch.Tensor]]:
    """``x`` cut into ``n`` equal row blocks, each with ``halo`` rows of its
    neighbours above and below (zeros beyond the first and last block), as
    ``run_each``'s chunks."""
    L = x.shape[0]
    if L % n:
        raise ValueError(f"{what}: {L} leading rows do not split into {n} equal "
                         f"'space' shards")
    rows = L // n
    zeros = x.new_zeros((halo,) + tuple(x.shape[1:]))
    out = []
    for i in range(n):
        top = x[i * rows - halo:i * rows] if i > 0 else zeros
        bottom = x[(i + 1) * rows:(i + 1) * rows + halo] if i < n - 1 else zeros
        out.append([torch.cat([top, x[i * rows:(i + 1) * rows], bottom])])
    return out


def make_halo_dense_scorer(model: nn.Module, mesh: Mesh):
    """Dense scoring of ONE micrograph with its rows split over the
    ``space`` axis. Each shard is padded with its neighbours' ``width // 2``
    edge rows (zeros at the image's top and bottom) and zero-padded in W,
    scored VALID, and keeps its own rows: the whole-image score map."""
    devices = mesh.space_devices
    reps = replicas(model, devices)
    halo = model.spec.width // 2

    def shard(i, dev, block):
        return reps[i](F.pad(block, (halo, halo))[None], pad=False)[0]

    @torch.inference_mode()
    def score(image) -> torch.Tensor:
        image = torch.as_tensor(image, dtype=torch.float32).to(devices[0])
        n = len(devices)
        if image.shape[0] // n < halo:
            raise ValueError(
                f"halo-sharded scoring needs >= {halo} rows per shard "
                f"(receptive field {model.spec.width}), got {image.shape[0] // n}; "
                f"use fewer 'space' shards for this image")
        outs = run_each(shard, devices, _halo_blocks(image, n, halo, "halo-sharded scoring"))
        return torch.cat([o.to(devices[0]) for o in outs])

    return score


def make_halo_denoiser(model: nn.Module, mesh: Mesh, halo: int = 256):
    """Denoise ONE micrograph (rows) or tomogram (z-slabs) split over the
    ``space`` axis. The mean and std of the whole image come from every
    shard's sums first; each shard is normalized, gets a ``halo``-row apron
    of its neighbours' normalized rows (zeros at the outer edges, as the
    whole image's SAME convolutions see), is denoised, loses its apron and
    is restored to the image's scale. Exact for pool-free models (affine,
    fcnn) when the halo covers the receptive field; near shard edges the
    pooling U-Nets differ as the reference's patch mode does. The network
    runs in the model's dtype (bfloat16 for ``Denoise(dtype="bf16")``), the
    statistics in float32."""
    devices = mesh.space_devices
    wdtype = next(model.parameters()).dtype
    reps = replicas(model, devices)

    def shard(i, dev, block):
        y = reps[i](block.to(wdtype)[None, None])[0, 0]
        return y[halo:-halo].float()

    @torch.inference_mode()
    def denoise(image) -> torch.Tensor:
        image = torch.as_tensor(image, dtype=torch.float32).to(devices[0])
        n = len(devices)
        if image.shape[0] // n < halo:
            raise ValueError(
                f"halo-sharded denoising needs >= {halo} leading rows per "
                f"shard, got {image.shape[0] // n}; lower the halo or use fewer "
                f"'space' shards for this image")
        rows = image.shape[0] // n
        shards = [image[i * rows:(i + 1) * rows].to(dev) for i, dev in enumerate(devices)]
        # the whole image's statistics: each shard's sums, added up
        stats = sum(torch.stack([b.sum(), (b ** 2).sum()]).to(devices[0]) for b in shards)
        mu = stats[0] / image.numel()
        std = torch.sqrt(stats[1] / image.numel() - mu ** 2)
        # normalize BEFORE the aprons, so that the zeros at the outer edges
        # are the whole-image convolutions' zero padding
        normed = torch.cat([((b - mu.to(b.device)) / std.to(b.device)).to(devices[0])
                            for b in shards])
        outs = run_each(shard, devices, _halo_blocks(normed, n, halo, "halo-sharded denoising"))
        return torch.cat([o.to(devices[0]) for o in outs]) * std + mu

    return denoise


# ---------------------------------------------------------------------------
# data-parallel training step (mesh.py:228-237)
# ---------------------------------------------------------------------------

def world():
    """(torch.distributed, rank, world size) when the process group is up,
    else (None, 0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist, dist.get_rank(), dist.get_world_size()
    return None, 0, 1


def gather_live(dist, world: int, rank: int, local: torch.Tensor) -> torch.Tensor:
    """Every process's ``local`` concatenated in rank order, with this
    process's own part the live tensor (its gradient flows), the others
    detached copies."""
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local.detach().contiguous())
    parts[rank] = local
    return torch.cat(parts)


def make_dp_train_step(loss_fn: Callable, mesh: Optional[Mesh], l2: float = 0.0,
                       autoencoder: float = 0.0):
    """The training step with the crops split over the mesh's data axis
    and, when ``torch.distributed`` is initialized, over processes:
    ``trainer.make_train_step(..., mesh=mesh, distributed=True)``, as the
    JAX package's is its ``make_train_step`` over the mesh."""
    from topaz_tpu_torch.train.trainer import make_train_step

    return make_train_step(loss_fn, l2=l2, autoencoder=autoencoder, mesh=mesh,
                           distributed=True)
