"""Streaming acquisition watcher: process micrographs as they are written
(port of topaz_tpu/watch.py).

``watch`` monitors a directory for new micrographs, waits for each file to
finish writing (its size unchanged across polls), then runs everything
that arrived through the batched pipeline (``pipeline.MicrographPipeline``:
downsample, GMM normalize, dense scoring, NMS with the disk-max kernel on
the card [, denoise]), appending picks to the output file or writing one
file a micrograph, and writing denoised previews.

Crash and restart safety: a JSON manifest beside the output records every
processed file with its size and is replaced atomically after each batch,
and picks are flushed each batch, so a restarted watcher resumes where the
previous one stopped, reprocessing and dropping no micrograph. The
pipeline and its models stay loaded across polls.
"""

from __future__ import annotations

import fnmatch
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from topaz_tpu_torch.utils.printing import report


class DirectoryWatcher:
    """Tracks a directory for new, fully written files matching patterns.

    A file is *stable*, presumed completely written, once its size is
    unchanged between two consecutive :meth:`scan` calls (microscope
    software writes sequentially; a growing file keeps changing size).
    ``settle_polls`` raises the bar to N unchanged polls for slow network
    filesystems. Files listed in the manifest are never offered again
    unless they have grown since they were processed (``reprocess_grown``).
    """

    def __init__(self, input_dir: str, patterns: Sequence[str] = ("*.mrc",),
                 manifest_path: Optional[str] = None, settle_polls: int = 1,
                 reprocess_grown: bool = False, recursive: bool = False):
        self.input_dir = input_dir
        self.patterns = list(patterns)
        self.manifest_path = manifest_path
        self.settle_polls = max(1, int(settle_polls))
        self.reprocess_grown = bool(reprocess_grown)
        # recursive: acquisition software (EPU, SerialEM) nests micrographs
        # in per-grid-square subdirectories created during the run
        self.recursive = bool(recursive)
        #: path -> (last seen size, consecutive stable polls)
        self._pending: Dict[str, Tuple[int, int]] = {}
        #: path -> size when offered by scan(); never offered again at that
        #: size, so a corrupt file skipped by the pipeline is not retried
        #: every poll (mark_done moves entries out of here)
        self._offered: Dict[str, int] = {}
        #: path -> size at processing time
        self.done: Dict[str, int] = {}
        if manifest_path and os.path.exists(manifest_path):
            with open(manifest_path) as f:
                data = json.load(f)
            self.done = {k: int(v["size"]) for k, v in data.get("processed", {}).items()}

    def _matches(self, name: str) -> bool:
        return any(fnmatch.fnmatch(name, p) for p in self.patterns)

    def _entries(self):
        if not self.recursive:
            with os.scandir(self.input_dir) as it:
                yield from it
            return
        stack = [self.input_dir]
        while stack:
            try:
                with os.scandir(stack.pop()) as it:
                    for e in it:
                        if e.is_dir(follow_symlinks=False):
                            stack.append(e.path)
                        else:
                            yield e
            except OSError:
                continue  # directory vanished mid-scan

    def scan(self) -> List[str]:
        """One poll; returns the newly *stable* files, by mtime then name,
        so processing follows acquisition order."""
        found = []
        for e in self._entries():
            if not e.is_file() or not self._matches(e.name):
                continue
            try:
                st = e.stat()
            except OSError:
                continue  # vanished mid-scan
            path = e.path
            if path in self.done:
                if not (self.reprocess_grown and st.st_size > self.done[path]):
                    continue
            if self._offered.get(path) == st.st_size:
                continue  # already handed out at this size
            size, stable = self._pending.get(path, (-1, 0))
            stable = stable + 1 if st.st_size == size else 0
            self._pending[path] = (st.st_size, stable)
            if stable >= self.settle_polls:
                found.append((st.st_mtime, e.name, path))
        ready = [p for _, _, p in sorted(found)]
        for p in ready:
            self._offered[p] = self._pending.pop(p)[0]
        return ready

    def mark_done(self, path: str) -> None:
        self.done[path] = self._offered.pop(path, -1)

    def requeue(self, paths: Sequence[str]) -> None:
        """Forget that these files were offered, so a later scan offers
        them again: after a transient device failure an interrupted batch
        is retried on the next poll instead of being lost."""
        for p in paths:
            self._offered.pop(p, None)

    def save_manifest(self) -> None:
        if not self.manifest_path:
            return
        payload = {"processed": {k: {"size": v} for k, v in self.done.items()}}
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=0)
        os.replace(tmp, self.manifest_path)


def watch_directory(
    input_dir: str,
    output: str,
    model: str = "resnet16_u32",
    denoise_model: Optional[str] = None,
    denoised_dir: Optional[str] = None,
    scale: int = 8,
    radius: int = 14,
    threshold: float = -6.0,
    batch_size: int = 1,
    patterns: Sequence[str] = ("*.mrc",),
    poll_interval: float = 5.0,
    settle_polls: int = 1,
    recursive: bool = False,
    once: bool = False,
    idle_timeout: Optional[float] = None,
    precision=None,
    bins: int = 0,
    dtype=None,
    skip_errors: bool = True,
    up_scale: Optional[float] = None,
    per_micrograph: bool = False,
    out_format: str = "coord",
    suffix: str = "",
    device="cuda",
    mesh=None,
    _poll_hook=None,
) -> int:
    """Watch ``input_dir`` and stream new micrographs through the pipeline
    on ``device``, or split over ``mesh`` (parallel/mesh.py). The JAX
    package's keywords, and ``device``.

    Picks are appended to ``output`` (``image_name\\tx_coord\\ty_coord\\tscore``,
    one header when the file is created) with coordinates in RAW pixels
    (``up_scale`` defaults to ``scale``, as ``extract -x``); with
    ``denoise_model`` a denoised preview of each micrograph, at the
    pipeline's working scale, goes to ``denoised_dir``. Returns the number
    of micrographs processed.

    ``per_micrograph=True`` treats ``output`` as a DIRECTORY and writes one
    coordinate file a micrograph (``<name><suffix>.<format>``, any
    ``extract --format``); the manifest lives in that directory and each
    file is written before its micrograph is marked done.

    Exit: ``once=True`` processes the current backlog and returns;
    ``idle_timeout`` returns after that many seconds without a new stable
    file; otherwise it runs until interrupted (^C or SIGTERM; the manifest
    makes that safe at any point). ``_poll_hook`` (tests) is called before
    each poll and may return False to stop.
    """
    from topaz_tpu_torch.io.coordinates import Coordinates, write_table
    from topaz_tpu_torch.io.mrc import write as write_mrc
    from topaz_tpu_torch.pipeline import MicrographPipeline
    from topaz_tpu_torch.utils.retry import is_transient_device_error
    from topaz_tpu_torch.utils.signals import sigterm_as_interrupt

    if up_scale is None:
        up_scale = float(scale)
    settle_polls = max(1, int(settle_polls))
    pipe = MicrographPipeline(
        model=model, denoise_model=denoise_model, scale=scale, radius=radius,
        threshold=threshold, normalize=True, precision=precision, bins=bins,
        dtype=dtype, skip_errors=skip_errors, device=device, mesh=mesh)

    if per_micrograph:
        out_dir = output
        os.makedirs(out_dir, exist_ok=True)
        manifest_path = os.path.join(out_dir, "watch.manifest.json")
        anchor_dir = out_dir
    else:
        os.makedirs(os.path.dirname(os.path.abspath(output)) or ".", exist_ok=True)
        manifest_path = output + ".manifest.json"
        anchor_dir = os.path.dirname(os.path.abspath(output))
    if denoise_model is not None:
        denoised_dir = denoised_dir or os.path.join(anchor_dir, "denoised")
        os.makedirs(denoised_dir, exist_ok=True)

    watcher = DirectoryWatcher(input_dir, patterns=patterns, manifest_path=manifest_path,
                               settle_polls=settle_polls, recursive=recursive)

    out_f = None
    if not per_micrograph:
        fresh = not os.path.exists(output) or os.path.getsize(output) == 0
        out_f = open(output, "a")
        if fresh:
            print("image_name\tx_coord\ty_coord\tscore", file=out_f, flush=True)

    n_processed = 0

    def _process_ready(ready):
        nonlocal n_processed
        for result in pipe.process(ready, batch_size=batch_size):
            # scores float32 and coords integer numpy arrays, so that a line
            # formats a numpy int and a numpy float32 as the JAX package's
            path, scores, coords = result[:3]
            name, in_ext = os.path.splitext(os.path.basename(path))
            if up_scale != 1:
                coords = np.round(np.asarray(coords) * up_scale).astype(int)
            if per_micrograph:
                table = Coordinates(np.array([name] * len(scores), dtype=object),
                                    coords[:, 0], coords[:, 1], score=scores)
                out_path = os.path.join(out_dir, name + suffix + "." + out_format)
                with open(out_path, "w") as pf:
                    write_table(pf, table, format=out_format, image_ext=in_ext)
            else:
                for i in range(len(scores)):
                    print(f"{name}\t{coords[i, 0]}\t{coords[i, 1]}\t{scores[i]}", file=out_f)
            if len(result) > 3 and denoised_dir is not None:
                write_mrc(os.path.join(denoised_dir, name + ".mrc"),
                          np.asarray(result[3], dtype=np.float32))
            watcher.mark_done(path)
            n_processed += 1
            report(f"watch: {name}: {len(scores)} picks")

    last_activity = time.monotonic()
    polls_done = 0
    # under systemd/k8s the stop path is SIGTERM: route it through the same
    # orderly shutdown as ^C (manifest saved, output flushed)
    try:
        with sigterm_as_interrupt():
            while True:
                if _poll_hook is not None and _poll_hook() is False:
                    break
                ready = watcher.scan()
                polls_done += 1
                if ready:
                    last_activity = time.monotonic()
                    report(f"watch: {len(ready)} new micrograph(s)")
                    try:
                        _process_ready(ready)
                    except Exception as e:  # noqa: BLE001 - transient-filtered
                        if not is_transient_device_error(e):
                            raise
                        # outlasted the pipeline's own retry: requeue what this
                        # poll did not finish and keep watching
                        lost = [p for p in ready if p not in watcher.done]
                        watcher.requeue(lost)
                        report(f"watch: transient device failure ({type(e).__name__}: {e}); "
                               f"{len(lost)} micrograph(s) requeued for the next poll")
                    else:
                        # files the pipeline skipped (corrupt, skip_errors) are
                        # done at their offered size, not retried every poll
                        for p in ready:
                            if p not in watcher.done:
                                watcher.mark_done(p)
                    if out_f is not None:
                        out_f.flush()
                    watcher.save_manifest()
                if once:
                    # the stability check needs settle_polls + 1 sightings of an
                    # unchanged size, so the backlog is ready on poll
                    # settle_polls + 1; a file still pending then is mid-write
                    if polls_done > settle_polls:
                        break
                if idle_timeout is not None and time.monotonic() - last_activity >= idle_timeout:
                    report(f"watch: no new files for {idle_timeout:g}s — done")
                    break
                time.sleep(poll_interval)
    except KeyboardInterrupt:
        report("watch: interrupted — manifest saved, safe to restart")
    finally:
        if out_f is not None:
            out_f.close()
        watcher.save_manifest()
    report(f"watch: processed {n_processed} micrograph(s) total")
    return n_processed


def watch_from_args(args) -> int:
    """CLI adapter (cli/commands/watch.py). ``-d`` takes an index, ``-1``
    (the current CUDA device), ``cpu``, or ``-2``: the batches split over
    every CUDA device (``hybrid_mesh_for``)."""
    from topaz_tpu_torch.parallel.devices import hybrid_mesh_for, resolve_devices

    devices = resolve_devices(args.device)
    device, mesh = devices[0], None
    if args.device == -2:
        mesh = hybrid_mesh_for(devices, args.batch_size, warn=True)
        if mesh is not None:
            nd, ns = mesh.shape["data"], mesh.shape["space"]
            report(f"watch: pipeline sharded over {nd * ns} devices"
                   + (f" ({nd} batch x {ns} spatial)" if ns > 1 else ""))
    # bf16 runs the pipeline's denoise arm in bfloat16; scores and NMS stay
    # float32, so picks keep their parity
    dtype = "bf16" if args.precision == "bf16" else None
    return watch_directory(
        input_dir=args.dir,
        output=args.output,
        model=args.model,
        denoise_model=args.denoise_model or None,
        denoised_dir=args.denoised_output,
        scale=args.scale,
        radius=args.radius,
        threshold=args.threshold,
        batch_size=args.batch_size,
        patterns=args.pattern,
        poll_interval=args.poll_interval,
        settle_polls=args.settle_polls,
        recursive=args.recursive,
        once=args.once,
        idle_timeout=args.idle_timeout,
        bins=args.bins,
        dtype=dtype,
        skip_errors=not args.fail_fast,
        per_micrograph=args.per_micrograph,
        out_format=args.out_format or "coord",
        suffix=args.suffix or "",
        device=device,
        mesh=mesh,
    )
