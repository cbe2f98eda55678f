"""``warmup``: get a session's programs ready before the first micrograph
(port of topaz_tpu/warmup.py).

The JAX command seeds XLA's persistent compile cache. The port has no
compiled programs to cache; what lasts beyond one process is the build of
its hand-written CUDA kernels (``csrc/*.cu``, built by ``nvcc`` into
``topaz_tpu_torch/_build/``, reused by every later process of this
checkout). ``warmup`` builds them first, then runs every program a session
runs once for each raw shape and batch size: the batched extraction
pipeline (device Fourier crop, GMM normalize, dense scoring, NMS with the
disk-max kernel [, the denoise arm]) as ``watch``, ``serve`` and batched
``extract`` run it, and, with a denoiser, the whole-image denoise of
``denoise`` and ``/denoise``. That run warms only its own process: the CUDA
context, cuDNN's algorithm choices and the loaded weights die with it, so
a long-running ``watch`` or ``serve`` warms itself on its first batch.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from topaz_tpu_torch.utils.printing import report

# the CUDA sources whose build lasts beyond the process (csrc/<name>.cu)
KERNELS = ("disk_max",)


def parse_shapes(text: str) -> Tuple[Tuple[int, int], ...]:
    """``"4096x4096,5760x4092"`` -> ((4096, 4096), (5760, 4092))."""
    shapes = []
    for tok in text.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        try:
            h, w = (int(v) for v in tok.split("x"))
        except ValueError as e:
            raise ValueError(f"bad shape {tok!r}: expected HEIGHTxWIDTH, e.g. 4096x4096") from e
        shapes.append((h, w))
    if not shapes:
        raise ValueError("no shapes given")
    return tuple(shapes)


def warmup(model: str = "resnet16_u32", denoise_model: Optional[str] = None, scale: int = 8,
           radius: int = 14, threshold: float = -6.0,
           shapes: Sequence[Tuple[int, int]] = ((4096, 4096),),
           batch_sizes: Sequence[int] = (1, 8), bins: int = 0, precision=None, dtype=None,
           device="cuda", mesh=None) -> int:
    """Build the CUDA kernels (on a CUDA device), then run each shape x
    batch size through the pipeline once (split over ``mesh`` when given),
    and the whole-image denoise once a shape. The JAX package's keywords,
    and ``device``. Returns the number of programs run."""
    from topaz_tpu_torch.denoise import Denoise
    from topaz_tpu_torch.device import resolve_device
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.pipeline import MicrographPipeline

    dev = resolve_device(mesh.devices[0, 0] if mesh is not None else device)
    t_all = time.time()
    if dev.type == "cuda":
        from topaz_tpu_torch._build import build_libraries

        paths = build_libraries(list(KERNELS))
        report(f"warmup: CUDA kernels {', '.join(KERNELS)} built in "
               f"{time.time() - t_all:.1f}s into {os.path.dirname(paths[KERNELS[0]])}")
    # the construction watch and serve use: the same programs, the
    # pipeline's picking-scale denoise arm included when a denoiser is given
    pipe = MicrographPipeline(model=model, denoise_model=denoise_model, scale=scale,
                              radius=radius, threshold=threshold, normalize=True,
                              precision=precision, bins=bins, dtype=dtype, device=dev,
                              mesh=mesh)
    denoiser = None
    if denoise_model is not None:
        denoiser = Denoise(denoise_model, dtype=dtype, device=dev)

    rng = np.random.default_rng(0)
    n_programs = 0
    with tempfile.TemporaryDirectory(prefix="topaz_warmup_") as tmp:
        for h, w in shapes:
            path = os.path.join(tmp, f"warm_{h}x{w}.mrc")
            mrc.write(path, rng.normal(0, 1, (h, w)).astype(np.float32))
            for bs in batch_sizes:
                t0 = time.time()
                for _ in pipe.process([path] * bs, batch_size=bs):
                    pass
                report(f"warmup: extract {h}x{w} batch {bs} ready in {time.time() - t0:.1f}s")
                n_programs += 1
            if denoiser is not None:
                t0 = time.time()
                denoiser.denoise(np.asarray(mrc.read(path)[0], dtype=np.float32),
                                 patch_size=0).cpu()
                report(f"warmup: denoise {h}x{w} ready in {time.time() - t0:.1f}s")
                n_programs += 1
    carried = ("the CUDA kernels' build carries over to later processes; "
               if dev.type == "cuda" else "")
    report(f"warmup: {n_programs} programs run once in {time.time() - t_all:.1f}s on {dev}; "
           f"{carried}the CUDA context, cuDNN's choices and the loaded models warm this "
           f"process only")
    return n_programs


def warmup_from_args(args) -> int:
    """CLI adapter (cli/commands/warmup.py); ``-d -2`` warms the pipeline
    split over every CUDA device, for the largest batch size."""
    from topaz_tpu_torch.parallel.devices import hybrid_mesh_for, resolve_devices

    devices = resolve_devices(args.device)
    batch_sizes = sorted({int(b) for b in args.batch_sizes.split(",") if b})
    mesh = hybrid_mesh_for(devices, max(batch_sizes), warn=True)
    dtype = "bf16" if args.precision == "bf16" else None
    warmup(model=args.model, denoise_model=args.denoise_model, scale=args.scale,
           radius=args.radius, threshold=args.threshold, shapes=parse_shapes(args.shapes),
           batch_sizes=batch_sizes, bins=args.bins, dtype=dtype, device=devices[0],
           mesh=mesh)
    return 0
