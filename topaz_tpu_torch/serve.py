"""``serve``: picking and denoising over HTTP (port of topaz_tpu/serve.py).

A microscope facility or processing portal POSTs micrographs and gets picks
(JSON) or denoised images (MRC) back, with the models loaded and the card
kept warm between requests.

Protocol (the standard library on both ends):

  GET  /healthz   liveness and configuration
  GET  /metrics   Prometheus text exposition (the /healthz numbers and a
                  request latency histogram)
  GET  /models    bundled picker and denoiser names
  POST /extract   body = one micrograph file (MRC/TIFF/PNG, anything
                  io.image.load_image reads); response JSON
                  ``{"picks": [{"x", "y", "score"}, ...], "count", "scale",
                  "threshold"}`` with x/y in RAW input pixels (the pipeline
                  scores at the downsampled scale; the server scales the
                  coordinates back, as ``watch`` does). ``?threshold=T``
                  filters a request's picks; T below the server's threshold
                  is a 400, since NMS already ran at the server's.
  POST /denoise   body = one micrograph; response = the denoised MRC
                  (whole image on the device; a frame too large for device
                  memory falls back to patches).

Device work runs on one worker thread that owns the device; HTTP I/O and
file parsing run in a thread a request (``ThreadingHTTPServer``), so
uploads overlap device work. Concurrent requests are batched dynamically:
the worker collects up to ``max_batch`` queued requests of one kind,
waiting at most ``batch_window_ms`` after the first, and runs them as one
device batch: /extract through the batched pipeline (mixed sizes go to
their shape buckets), /denoise through ``Denoise.denoise_batch`` for
same-shape frames. An unreadable file fails only its own request.

Every job carries a deadline (``device_timeout``): a request the device has
not answered by then gets 504 instead of waiting forever, and when the
worker was executing that job (a wedged device call) the worker thread is
abandoned and replaced, so the next request is served by a fresh worker.
A job whose submitter has timed out is dropped before (and, between
same-shape groups of a denoise batch, during) device work. Errors the
device raises (out of memory, or a sticky CUDA error after which every
later call fails) answer their requests with 500; the server stays up.
"""

from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from topaz_tpu_torch.utils.printing import report

# formats load_image dispatches on; the temp file's suffix comes from the
# request's Content-Type (default: MRC, the microscope's own format)
_CONTENT_SUFFIX = {
    "application/x-mrc": ".mrc",
    "image/tiff": ".tiff",
    "image/png": ".png",
    "image/jpeg": ".jpg",
}


class _Job:
    """One queued device request; the HTTP thread waits on ``done``.
    ``abandoned`` is set by the submitter when its deadline expires: a
    worker that dequeues (or finishes) an abandoned job discards it.
    ``started`` is set by the worker, under the service lock together with
    ``_current``, when the batch is committed to the device: the watchdog
    reads started-and-not-done as a wedged device call and not-started as
    queue congestion, with no window in which one looks like the other."""

    __slots__ = ("kind", "path", "done", "result", "error", "abandoned", "started")

    def __init__(self, kind: str, path: str):
        self.kind = kind
        self.path = path
        self.done = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        self.abandoned = False
        self.started = False


class _Busy(Exception):
    def __init__(self, depth):
        super().__init__(f"server is saturated ({depth} requests queued "
                         f"for the device); retry with backoff")


class _Timeout(Exception):
    def __init__(self, seconds):
        super().__init__(f"device did not answer within --device-timeout "
                         f"{seconds:g}s; the request was abandoned")


class _TooLarge(Exception):
    def __init__(self, n):
        super().__init__(f"request body of {n} bytes exceeds the server's "
                         f"--max-request-bytes limit")


_SHUTDOWN = object()


class TopazService:
    """The models and pipeline shared across requests, and the device
    worker that runs them. The JAX package's keywords, plus ``device``
    (default: the current CUDA device; ``"cpu"`` only when asked)."""

    def __init__(self, model: str = "resnet16_u32", denoise_model: Optional[str] = None,
                 scale: int = 8, radius: int = 14, threshold: float = -6.0, precision=None,
                 bins: int = 0, dtype=None, max_request_bytes: int = 2 << 30,
                 max_batch: int = 8, batch_window_ms: float = 20.0, queue_depth: int = 64,
                 device_timeout: float = 300.0, device="cuda"):
        from topaz_tpu_torch.device import resolve_device
        from topaz_tpu_torch.pipeline import MicrographPipeline

        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.model = model
        self.denoise_model = denoise_model
        self.scale = scale
        self.radius = radius
        self.threshold = threshold
        self.max_request_bytes = max_request_bytes
        self.max_batch = max(1, int(max_batch))
        self.batch_window = max(0.0, float(batch_window_ms)) / 1e3
        self.queue_depth = max(1, int(queue_depth))
        # skip_errors: a corrupt upload fails its own request (400), not the
        # batch it was coalesced into
        self.pipe = MicrographPipeline(
            model=model, scale=scale, radius=radius, threshold=threshold, normalize=True,
            precision=precision, bins=bins, dtype=dtype, skip_errors=True, device=dev)
        self._denoiser = None
        self._dtype = dtype
        self.started = time.time()
        self.device_timeout = max(0.0, float(device_timeout))
        self.n_extracted = 0
        self.n_denoised = 0
        self.n_batches = 0
        self.max_batch_seen = 0
        self.n_denoise_batches = 0
        self.max_denoise_batch_seen = 0
        self.n_timeouts = 0
        self.n_worker_restarts = 0
        # request latency histogram (submit -> result), Prometheus
        # cumulative-bucket convention, per request kind
        self._lat_buckets = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)
        self._lat = {k: {"counts": [0] * (len(self._lat_buckets) + 1), "sum": 0.0, "n": 0}
                     for k in ("extract", "denoise")}
        self._lock = threading.Lock()  # guards the queue swap, submit, counters
        self._current = None  # the batch the worker is executing
        self._abandoned_workers: list = []  # replaced threads, maybe wedged
        self._queue: "queue.Queue" = queue.Queue()
        self._worker = self._start_worker(self._queue, "topaz-serve-device")

    def _start_worker(self, q: "queue.Queue", name: str) -> threading.Thread:
        worker = threading.Thread(target=self._device_loop, args=(q,), name=name, daemon=True)
        worker.start()
        return worker

    # -- device worker -------------------------------------------------------
    def _device_loop(self, q: "queue.Queue"):
        """Owns the queue it was started with: after a watchdog replacement
        the old (possibly wedged) thread keeps polling the OLD queue, which
        only ever receives a _SHUTDOWN, and never races the new worker."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        pending = None
        while True:
            job = pending if pending is not None else q.get()
            pending = None
            if job is _SHUTDOWN:
                return
            if job.abandoned:
                continue
            batch = [job]
            deadline = time.monotonic() + self.batch_window
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN or nxt.kind != job.kind:
                    pending = nxt  # run the batch first, then this
                    break
                if not nxt.abandoned:
                    batch.append(nxt)
            # commit under the lock: drop jobs 504'd during the collection
            # window and mark the rest started (see _Job.started)
            with self._lock:
                batch = [j for j in batch if not j.abandoned]
                for j in batch:
                    j.started = True
                self._current = batch or None
            if not batch:
                continue
            if job.kind == "extract":
                self._run_extract_batch(batch)
            else:
                self._run_denoise_batch(batch)
            with self._lock:
                self._current = None
            if pending is _SHUTDOWN:
                return

    def _run_extract_batch(self, batch):
        try:
            with warnings.catch_warnings():
                # the pipeline's skip-errors warning becomes a per-request
                # 400 below
                warnings.simplefilter("ignore")
                results = {p: (s, c) for p, s, c in self.pipe.process(
                    [j.path for j in batch], batch_size=len(batch))}
        except Exception as e:  # noqa: BLE001 - delivered per request
            for j in batch:
                j.error = e
                j.done.set()
            return
        with self._lock:
            self.n_batches += 1
            self.max_batch_seen = max(self.max_batch_seen, len(batch))
        for j in batch:
            if j.path in results:
                j.result = results[j.path]
            else:
                j.error = ValueError("unreadable or corrupt micrograph (not a parseable "
                                     "MRC/TIFF/PNG/JPEG)")
            j.done.set()

    def _run_denoise_batch(self, batch):
        """Whole-image denoising; same-shape requests run as one batched
        forward (``Denoise.denoise_batch``, each frame with its own
        statistics, as the single-frame path), which falls back to one frame
        at a time when the batch does not fit in device memory."""
        from topaz_tpu_torch.io.image import load_image

        groups: dict = {}
        for j in batch:
            try:
                x = np.asarray(load_image(j.path), dtype=np.float32)
            except Exception as e:  # noqa: BLE001 - delivered per request
                j.error = e
                j.done.set()
                continue
            key = x.shape if x.ndim == 2 else None  # stacks stay singleton
            groups.setdefault(key, []).append((j, x))
        for shape, items in groups.items():
            # checked between device calls: a job 504'd while an earlier
            # group ran stops here
            items = [(j, x) for j, x in items if not j.abandoned]
            if not items:
                continue
            try:
                if shape is not None and len(items) > 1:
                    ys = self._get_denoiser().denoise_batch(np.stack([x for _, x in items]))
                    ys = ys.float().cpu().numpy()
                    with self._lock:
                        self.n_denoise_batches += 1
                        self.max_denoise_batch_seen = max(self.max_denoise_batch_seen,
                                                          len(items))
                    for (j, _), y in zip(items, ys):
                        j.result = y
                        j.done.set()
                else:
                    for j, x in items:
                        if j.abandoned:
                            continue
                        y = self._get_denoiser().denoise(x, patch_size=0)
                        j.result = y.float().cpu().numpy()
                        j.done.set()
            except Exception as e:  # noqa: BLE001 - delivered per request
                for j, _ in items:
                    if not j.done.is_set():
                        j.error = e
                        j.done.set()

    def _observe_latency(self, kind: str, seconds: float):
        with self._lock:
            h = self._lat[kind]
            i = 0
            while i < len(self._lat_buckets) and seconds > self._lat_buckets[i]:
                i += 1
            h["counts"][i] += 1
            h["sum"] += seconds
            h["n"] += 1

    def _submit(self, job: _Job):
        with self._lock:
            q = self._queue
            if q.qsize() >= self.queue_depth:
                raise _Busy(q.qsize())
            q.put(job)
        t0 = time.monotonic()
        if job.done.wait(self.device_timeout or None):
            self._observe_latency(job.kind, time.monotonic() - t0)
            if job.error is not None:
                raise job.error
            return job.result
        # deadline expired: abandon the job (504) and, if the worker was
        # executing it (a wedged device call), replace the worker
        job.abandoned = True
        with self._lock:
            self.n_timeouts += 1
        self._watchdog(job)
        raise _Timeout(self.device_timeout)

    def _watchdog(self, job: _Job):
        """Called when ``job`` missed its deadline. If the worker was
        executing it, the worker is wedged inside a device call (Python
        threads cannot be killed): abandon it, with its old queue, which
        only ever receives a _SHUTDOWN; move the pending jobs to a fresh
        queue and start a fresh worker on it."""
        with self._lock:
            if job.done.is_set():  # finished in the race window after wait
                return
            if not (job.started and self._worker.is_alive()):
                return  # queue congestion; the worker is healthy
            old_q, new_q = self._queue, queue.Queue()
            try:
                while True:
                    item = old_q.get_nowait()
                    if item is not _SHUTDOWN:
                        new_q.put(item)
            except queue.Empty:
                pass
            old_q.put(_SHUTDOWN)  # the exit signal for when it unwedges
            self._abandoned_workers.append(self._worker)
            self._queue = new_q
            self.n_worker_restarts += 1
            self._current = None
            self._worker = self._start_worker(
                new_q, f"topaz-serve-device-{self.n_worker_restarts}")
            report(f"serve: device call exceeded --device-timeout {self.device_timeout:g}s; "
                   f"worker replaced (restart #{self.n_worker_restarts})")

    def _suspect_workers(self) -> int:
        """Abandoned worker threads that are still alive (wedged)."""
        self._abandoned_workers = [t for t in self._abandoned_workers if t.is_alive()]
        return len(self._abandoned_workers)

    def close(self):
        """Stop the device worker (idempotent)."""
        if self._worker.is_alive():
            self._queue.put(_SHUTDOWN)
            self._worker.join(timeout=30)

    # -- request entry points ------------------------------------------------
    def _get_denoiser(self):
        if self._denoiser is None:
            from topaz_tpu_torch.denoise import Denoise

            self._denoiser = Denoise(self.denoise_model or "unet", dtype=self._dtype,
                                     device=self.device)
        return self._denoiser

    def extract(self, path: str, threshold: Optional[float] = None):
        """Run the picking pipeline on one saved micrograph; returns
        (scores, raw-scale integer coords)."""
        if threshold is not None and threshold < self.threshold:
            raise ValueError(
                f"requested threshold {threshold} is below the server's configured "
                f"{self.threshold}; picks below the configured threshold were suppressed "
                f"at NMS time — restart the server with a lower -t to serve them")
        scores, coords = self._submit(_Job("extract", path))
        scores = np.asarray(scores)
        coords = np.asarray(coords)
        if threshold is not None:
            keep = scores >= threshold
            scores, coords = scores[keep], coords[keep]
        if self.scale != 1 and len(coords):
            coords = np.round(coords * float(self.scale)).astype(int)
        with self._lock:
            self.n_extracted += 1
        return scores, coords

    def denoise(self, path: str) -> np.ndarray:
        y = self._submit(_Job("denoise", path))
        with self._lock:
            self.n_denoised += 1
        return y

    def health(self) -> dict:
        """Liveness and configuration. ``device`` is the torch device and
        ``device_name`` the card's name (``torch.cuda.get_device_name``), or
        ``cpu`` (the JAX package reports ``str(jax.devices()[0])``)."""
        name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else "cpu")
        return {
            "status": "ok",
            "device": str(self.device),
            "device_name": name,
            "model": self.model,
            "denoise_model": self.denoise_model,
            "scale": self.scale,
            "radius": self.radius,
            "threshold": self.threshold,
            "uptime_s": round(time.time() - self.started, 1),
            "extracted": self.n_extracted,
            "denoised": self.n_denoised,
            "queued": self._queue.qsize(),
            "max_batch": self.max_batch,
            "device_batches": self.n_batches,
            "largest_batch": self.max_batch_seen,
            "denoise_batches": self.n_denoise_batches,
            "largest_denoise_batch": self.max_denoise_batch_seen,
            "device_timeout_s": self.device_timeout,
            "device_timeouts": self.n_timeouts,
            "worker_restarts": self.n_worker_restarts,
            "suspect_workers": self._suspect_workers(),
            "worker_alive": self._worker.is_alive(),
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition: one gauge or counter a /healthz
        number, and the request latency histogram."""
        lines = []

        def emit(name, kind, help_, value):
            lines.append(f"# HELP topaz_{name} {help_}")
            lines.append(f"# TYPE topaz_{name} {kind}")
            lines.append(f"topaz_{name} {value}")

        emit("uptime_seconds", "gauge", "seconds since the server started",
             round(time.time() - self.started, 3))
        emit("extract_requests_total", "counter", "micrographs served through /extract",
             self.n_extracted)
        emit("denoise_requests_total", "counter", "micrographs served through /denoise",
             self.n_denoised)
        emit("device_batches_total", "counter",
             "device programs run for /extract (dynamic batching)", self.n_batches)
        emit("largest_batch", "gauge", "largest coalesced /extract batch so far",
             self.max_batch_seen)
        emit("denoise_batches_total", "counter",
             "batched device programs run for /denoise (dynamic batching)",
             self.n_denoise_batches)
        emit("largest_denoise_batch", "gauge", "largest coalesced /denoise batch so far",
             self.max_denoise_batch_seen)
        emit("device_timeouts_total", "counter",
             "requests that missed --device-timeout and got 504", self.n_timeouts)
        emit("worker_restarts_total", "counter",
             "device workers replaced after a wedged device call", self.n_worker_restarts)
        emit("suspect_workers", "gauge",
             "abandoned worker threads still alive (wedged device calls)",
             self._suspect_workers())
        emit("queue_depth", "gauge", "requests queued for the device", self._queue.qsize())
        emit("queue_capacity", "gauge", "queue depth at which requests get 503",
             self.queue_depth)
        lines.append("# HELP topaz_request_duration_seconds request latency from "
                     "device-queue submit to result")
        lines.append("# TYPE topaz_request_duration_seconds histogram")
        with self._lock:
            snap = {k: (list(h["counts"]), h["sum"], h["n"]) for k, h in self._lat.items()}
        for kind, (counts, total, n) in sorted(snap.items()):
            cum = 0
            for le, c in zip(self._lat_buckets, counts):
                cum += c
                lines.append(f'topaz_request_duration_seconds_bucket'
                             f'{{kind="{kind}",le="{le:g}"}} {cum}')
            lines.append(f'topaz_request_duration_seconds_bucket'
                         f'{{kind="{kind}",le="+Inf"}} {n}')
            lines.append(f'topaz_request_duration_seconds_sum{{kind="{kind}"}} {total:.6f}')
            lines.append(f'topaz_request_duration_seconds_count{{kind="{kind}"}} {n}')
        return "\n".join(lines) + "\n"


def _models_listing() -> dict:
    from topaz_tpu_torch.models.denoise_factory import PRETRAINED_DENOISERS
    from topaz_tpu_torch.models.factory import PRETRAINED_PICKERS

    return {"pickers": sorted(PRETRAINED_PICKERS), "denoisers": sorted(PRETRAINED_DENOISERS)}


class _Handler(BaseHTTPRequestHandler):
    service: TopazService  # set by make_server

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: dict) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _read_body_to_tempfile(self) -> str:
        n = int(self.headers.get("Content-Length") or 0)
        if n <= 0:
            raise ValueError("empty request body; POST the micrograph file")
        if n > self.service.max_request_bytes:
            raise _TooLarge(n)
        suffix = _CONTENT_SUFFIX.get(
            (self.headers.get("Content-Type") or "").split(";")[0].strip(), ".mrc")
        fd, path = tempfile.mkstemp(suffix=suffix, prefix="topaz_serve_")
        try:
            with os.fdopen(fd, "wb") as f:
                remaining = n
                while remaining:
                    chunk = self.rfile.read(min(remaining, 1 << 20))
                    if not chunk:
                        raise ValueError("truncated request body")
                    f.write(chunk)
                    remaining -= len(chunk)
        except BaseException:
            os.unlink(path)
            raise
        return path

    def log_message(self, fmt, *args):  # access logs through report
        report(f"serve: {self.address_string()} {fmt % args}")

    # -- routes ------------------------------------------------------------
    def do_GET(self):
        route = urlparse(self.path).path
        if route == "/healthz":
            return self._send_json(200, self.service.health())
        if route == "/models":
            return self._send_json(200, _models_listing())
        if route == "/metrics":
            return self._send(200, self.service.metrics_text().encode(),
                              "text/plain; version=0.0.4; charset=utf-8")
        return self._send_json(404, {"error": f"unknown route {route}; routes: /healthz "
                                              f"/metrics /models /extract /denoise"})

    def do_POST(self):
        url = urlparse(self.path)
        try:
            if url.path == "/extract":
                return self._extract(url)
            if url.path == "/denoise":
                return self._denoise()
            return self._send_json(404, {"error": f"unknown route {url.path}"})
        except _TooLarge as e:
            return self._send_json(413, {"error": str(e)})
        except _Busy as e:
            return self._send_json(503, {"error": str(e)})
        except _Timeout as e:
            return self._send_json(504, {"error": str(e)})
        except ValueError as e:
            return self._send_json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - boundary: report, don't die
            return self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    def _extract(self, url):
        q = parse_qs(url.query)
        threshold = float(q["threshold"][0]) if "threshold" in q else None
        path = self._read_body_to_tempfile()
        try:
            scores, coords = self.service.extract(path, threshold=threshold)
        finally:
            os.unlink(path)
        picks = [{"x": int(coords[i, 0]), "y": int(coords[i, 1]), "score": float(scores[i])}
                 for i in range(len(scores))]
        self._send_json(200, {
            "picks": picks, "count": len(picks), "scale": self.service.scale,
            "threshold": self.service.threshold if threshold is None else threshold})

    def _denoise(self):
        import io

        from topaz_tpu_torch.io import mrc

        path = self._read_body_to_tempfile()
        try:
            y = self.service.denoise(path)
        finally:
            os.unlink(path)
        buf = io.BytesIO()
        mrc.write(buf, y)
        self._send(200, buf.getvalue(), "application/x-mrc")


def make_server(service: TopazService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``port=0`` picks a free
    port (``server.server_address[1]`` has it)."""
    handler = type("TopazHandler", (_Handler,), {"service": service})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def serve_from_args(args) -> int:
    """CLI adapter (cli/commands/serve.py). ``-d`` takes an index, ``cpu``,
    or ``-1`` or ``-2``, the current CUDA device: the JAX adapter runs
    ``-d < 0`` on its default device (the service runs on one device)."""
    from topaz_tpu_torch.device import resolve_device
    from topaz_tpu_torch.utils.signals import sigterm_as_interrupt

    device = resolve_device(-1 if args.device == -2 else args.device)
    dtype = "bf16" if args.precision == "bf16" else None
    service = TopazService(
        model=args.model, denoise_model=args.denoise_model, scale=args.scale,
        radius=args.radius, threshold=args.threshold, bins=args.bins, dtype=dtype,
        max_request_bytes=args.max_request_bytes, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms, queue_depth=args.queue_depth,
        device_timeout=args.device_timeout, device=device)
    server = make_server(service, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    report(f"serve: listening on http://{host}:{port} (model {args.model}, scale "
           f"{args.scale}, threshold {args.threshold}, dynamic batching <= "
           f"{service.max_batch}, device {service.device}); POST micrographs to /extract "
           f"or /denoise")
    try:
        # SIGTERM (systemd/k8s stop) shares the ^C shutdown: close the
        # listener, drain the device worker
        with sigterm_as_interrupt():
            server.serve_forever()
    except KeyboardInterrupt:
        report("serve: interrupted — shutting down")
    finally:
        server.server_close()
        service.close()
    return 0
