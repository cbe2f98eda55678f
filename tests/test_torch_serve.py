"""The port's ``serve`` against the JAX package's, on the CPU.

``/extract`` picks of the port's server (``resnet8_u32``, ``scale=1,
radius=6, threshold=1.0`` as in tests/test_serve.py, the ``affine``
denoiser, ``device="cpu"``) against the JAX package's
``TopazService.extract`` on the same seeded 128^2 micrograph: identical
coordinates, scores within 1e-4 (float32 sums in other orders); ``/models``
equal to JAX's ``_models_listing()``. Then the JAX package's behaviour
tests on the port alone: the routes and status codes (400, 404, 413, 503,
504), worker replacement, a corrupt batchmate, coalescing of concurrent
``/extract`` and ``/denoise`` requests, abandoned jobs, a device error
that every later call repeats (500, never a hang, no loader thread left
running), SIGTERM, and the CLI's refusals."""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.serve import TopazService, _Busy, _Job, _Timeout, make_server
from torch_threads import one_torch_thread  # noqa: F401

BASE = dict(model="resnet8_u32", scale=1, radius=6, threshold=1.0, device="cpu")


def _start(service):
    srv = make_server(service, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, service):
    srv.shutdown()
    srv.server_close()
    service.close()


@pytest.fixture(scope="module")
def server():
    service = TopazService(denoise_model="affine", **BASE)
    srv, base = _start(service)
    yield base, service
    _stop(srv, service)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _micrograph_bytes(tmp_path, rng, shape=(128, 128), peaks=((40, 40), (90, 80))):
    x = rng.normal(0, 1, shape).astype(np.float32)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    for cy, cx in peaks:
        x -= 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 3.0**2)).astype(np.float32)
    p = tmp_path / "m.mrc"
    mrc.write(str(p), x)
    return str(p), p.read_bytes()


def _post(url, body, ctype="application/x-mrc"):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_extract_picks_identical_to_jax(server, tmp_path, rng):
    from topaz_tpu.serve import TopazService as JaxService

    base, _ = server
    path, body = _micrograph_bytes(tmp_path, rng)
    jax_service = JaxService(model="resnet8_u32", scale=1, radius=6, threshold=1.0)
    try:
        want_scores, want_coords = jax_service.extract(path)
    finally:
        jax_service.close()
    status, ctype, resp = _post(base + "/extract", body)
    assert status == 200 and ctype == "application/json"
    out = json.loads(resp)
    assert out["count"] == len(out["picks"]) == len(want_scores) >= 2
    assert out["scale"] == 1 and out["threshold"] == 1.0
    got = [(p["x"], p["y"]) for p in out["picks"]]
    assert got == [(int(x), int(y)) for x, y in np.asarray(want_coords)]
    np.testing.assert_allclose([p["score"] for p in out["picks"]], np.asarray(want_scores),
                               rtol=1e-4, atol=1e-5)


def test_models_listing_equal_to_jax(server):
    from topaz_tpu.serve import _models_listing as jax_models_listing

    base, _ = server
    m = _get_json(base + "/models")
    assert m == jax_models_listing()
    assert "resnet16_u32" in m["pickers"] and "unet" in m["denoisers"]


def test_healthz_names_the_device(server):
    base, _ = server
    h = _get_json(base + "/healthz")
    assert h["status"] == "ok" and h["model"] == "resnet8_u32"
    assert h["device"] == "cpu" and h["device_name"] == "cpu" and h["worker_alive"]


def test_metrics_prometheus_exposition(server, tmp_path, rng):
    base, service = server
    _, body = _micrograph_bytes(tmp_path, rng)
    _post(base + "/extract", body)
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        assert r.headers.get("Content-Type", "").startswith("text/plain")
        text = r.read().decode()
    lines = text.strip().splitlines()
    assert "# TYPE topaz_extract_requests_total counter" in lines
    sample = {ln.split()[0]: float(ln.split()[1]) for ln in lines if ln and not ln.startswith("#")}
    h = _get_json(base + "/healthz")
    assert sample["topaz_extract_requests_total"] == h["extracted"] == service.n_extracted >= 1
    assert sample["topaz_device_batches_total"] == h["device_batches"]
    assert sample["topaz_queue_capacity"] == service.queue_depth
    assert sample["topaz_uptime_seconds"] > 0
    assert "# TYPE topaz_request_duration_seconds histogram" in lines
    inf = sample['topaz_request_duration_seconds_bucket{kind="extract",le="+Inf"}']
    assert inf == sample['topaz_request_duration_seconds_count{kind="extract"}'] >= 1
    assert sample['topaz_request_duration_seconds_sum{kind="extract"}'] > 0
    buckets = [v for k, v in sample.items()
               if k.startswith('topaz_request_duration_seconds_bucket{kind="extract"')]
    assert buckets == sorted(buckets)


def test_extract_matches_direct_pipeline(server, tmp_path, rng):
    base, service = server
    path, body = _micrograph_bytes(tmp_path, rng)
    out = json.loads(_post(base + "/extract", body)[2])
    (_, s_ref, c_ref), = service.pipe.process([path])
    assert out["count"] == len(s_ref) >= 1
    for pick, s, c in zip(out["picks"], s_ref, c_ref):
        assert (pick["x"], pick["y"]) == (int(c[0]), int(c[1]))
        assert pick["score"] == pytest.approx(float(s), rel=1e-6)


def test_extract_threshold_filter_and_floor(server, tmp_path, rng):
    base, _ = server
    _, body = _micrograph_bytes(tmp_path, rng)
    all_picks = json.loads(_post(base + "/extract", body)[2])["picks"]
    hi = float(np.median([p["score"] for p in all_picks]))
    filtered = json.loads(_post(base + f"/extract?threshold={hi}", body)[2])["picks"]
    assert 0 < len(filtered) <= len(all_picks)
    assert all(p["score"] >= hi for p in filtered)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/extract?threshold=-99", body)
    assert ei.value.code == 400
    assert "configured" in json.loads(ei.value.read())["error"]


def test_denoise_roundtrip(server, tmp_path, rng):
    base, service = server
    path, body = _micrograph_bytes(tmp_path, rng, shape=(64, 64), peaks=((30, 30),))
    status, ctype, resp = _post(base + "/denoise", body)
    assert status == 200 and ctype == "application/x-mrc"
    out = tmp_path / "denoised.mrc"
    out.write_bytes(resp)
    y = mrc.read(str(out))[0]
    assert y.shape == (64, 64) and y.dtype == np.float32
    np.testing.assert_allclose(y, service.denoise(path), rtol=1e-5, atol=1e-6)


def test_bad_requests(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/nope", b"x")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/extract", b"")
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/extract", b"this is not an mrc file at all")
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/denoise", b"this is not an mrc file at all")
    assert ei.value.code in (400, 500)
    assert _get_json(base + "/healthz")["status"] == "ok"


def test_request_size_limit_413():
    service = TopazService(max_request_bytes=100, **BASE)
    srv, base = _start(service)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/extract", b"x" * 200)
        assert ei.value.code == 413
    finally:
        _stop(srv, service)


def _concurrently(fns):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)


def test_dynamic_batching_coalesces_concurrent_extracts(tmp_path, rng):
    """Three concurrent /extract requests (two shape buckets) run in at most
    two device batches, and each client gets its own picks."""
    # a 10 s window makes the coalescing deterministic: the batch fills
    service = TopazService(max_batch=3, batch_window_ms=10_000, **BASE)
    srv, base = _start(service)
    try:
        peaks = [((30, 40),), ((80, 30), (40, 90)), ((60, 60),)]
        shapes = [(128, 128), (128, 128), (160, 128)]
        bodies = []
        for i, (s, p) in enumerate(zip(shapes, peaks)):
            d = tmp_path / f"m{i}"
            d.mkdir()
            bodies.append(_micrograph_bytes(d, rng, shape=s, peaks=p)[1])
        results = [None] * 3

        def hit(i):
            results[i] = json.loads(_post(base + "/extract", bodies[i])[2])

        _concurrently([lambda i=i: hit(i) for i in range(3)])
        for r, pk in zip(results, peaks):
            got = {(p["x"], p["y"]) for p in r["picks"]}
            for cy, cx in pk:
                assert any(abs(x - cx) <= 3 and abs(y - cy) <= 3 for x, y in got), (pk, got)
        assert service.n_extracted == 3
        assert service.n_batches <= 2 and service.max_batch_seen >= 2
    finally:
        _stop(srv, service)


def test_corrupt_batchmate_fails_alone(tmp_path, rng):
    service = TopazService(max_batch=2, batch_window_ms=10_000, **BASE)
    srv, base = _start(service)
    try:
        _, good = _micrograph_bytes(tmp_path, rng)
        outcome = {}

        def hit(name, body):
            try:
                outcome[name] = ("ok", json.loads(_post(base + "/extract", body)[2]))
            except urllib.error.HTTPError as e:
                outcome[name] = ("err", e.code)

        _concurrently([lambda: hit("good", good), lambda: hit("bad", b"not an mrc at all")])
        assert outcome["good"][0] == "ok" and outcome["good"][1]["count"] >= 1
        assert outcome["bad"] == ("err", 400)
        assert service.max_batch_seen == 2
    finally:
        _stop(srv, service)


def test_device_timeout_504_and_worker_recovery(tmp_path, rng):
    """A wedged device call 504s the waiting request near the deadline,
    the worker is replaced and the next request is served; the abandoned
    worker counts as a suspect until it is released."""
    service = TopazService(device_timeout=300.0, **BASE)
    srv, base = _start(service)
    release = threading.Event()
    real_process = service.pipe.process
    calls = []

    def wedged_process(*a, **kw):
        if not calls:
            calls.append("wedged")
            release.wait(timeout=120)  # a hung device call
            return []
        return real_process(*a, **kw)

    try:
        _, body = _micrograph_bytes(tmp_path, rng)
        _post(base + "/extract", body)
        service.pipe.process = wedged_process
        service.device_timeout = 2.0
        t0 = time.time()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/extract", body)
        assert ei.value.code == 504 and time.time() - t0 < 30
        assert "device-timeout" in json.loads(ei.value.read())["error"]
        assert service.n_timeouts == 1 and service.n_worker_restarts == 1
        service.device_timeout = 120.0
        status, _, resp = _post(base + "/extract", body)
        assert status == 200 and json.loads(resp)["count"] >= 1
        h = _get_json(base + "/healthz")
        assert h["worker_alive"] and h["worker_restarts"] == 1
        assert h["suspect_workers"] == 1
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert "topaz_device_timeouts_total 1" in text
        assert "topaz_worker_restarts_total 1" in text
        assert "topaz_suspect_workers 1" in text
    finally:
        release.set()
        service.pipe.process = real_process
        _stop(srv, service)
    for _ in range(100):
        if service._suspect_workers() == 0:
            break
        time.sleep(0.1)
    assert service._suspect_workers() == 0


def test_denoise_dynamic_batching(tmp_path, rng):
    """Concurrent same-shape /denoise requests run as one batched forward,
    equal to the single-frame path; /extract and /denoise requests queued
    together go to batches of their own kind."""
    service = TopazService(denoise_model="affine", max_batch=3, batch_window_ms=10_000, **BASE)
    srv, base = _start(service)
    try:
        paths, bodies = [], []
        for i in range(3):
            d = tmp_path / f"m{i}"
            d.mkdir()
            p, b = _micrograph_bytes(d, rng, shape=(96, 96), peaks=((30 + 10 * i, 40),))
            paths.append(p)
            bodies.append(b)
        results = [None] * 3

        def hit(i):
            _, ctype, resp = _post(base + "/denoise", bodies[i])
            assert ctype == "application/x-mrc"
            results[i] = resp

        _concurrently([lambda i=i: hit(i) for i in range(3)])
        assert service.n_denoised == 3
        assert service.n_denoise_batches == 1 and service.max_denoise_batch_seen == 3
        service.batch_window = 0.0  # the single-frame references run alone
        for i in range(3):
            out = tmp_path / f"out{i}.mrc"
            out.write_bytes(results[i])
            ref = service.denoise(paths[i])  # alone: the single-frame path
            np.testing.assert_allclose(mrc.read(str(out))[0], ref, rtol=1e-4, atol=1e-5)

        service.batch_window = 0.5
        picks, denoised = {}, {}
        _concurrently(
            [lambda i=i: picks.update({i: json.loads(_post(base + "/extract", bodies[i])[2])})
             for i in range(2)]
            + [lambda i=i: denoised.update({i: _post(base + "/denoise", bodies[i])[2]})
               for i in range(2)])
        assert len(picks) == len(denoised) == 2
        assert all(p["count"] >= 1 for p in picks.values())
        assert service.n_batches <= 3 and service.n_denoise_batches <= 3
    finally:
        _stop(srv, service)


def test_queue_backpressure_503(tmp_path, rng):
    service = TopazService(queue_depth=1, **BASE)
    service.close()  # stop the worker so the queue cannot drain
    service._queue.put(_Job("extract", "placeholder"))
    with pytest.raises(_Busy):
        service._submit(_Job("extract", "x"))
    srv, base = _start(service)
    try:
        _, body = _micrograph_bytes(tmp_path, rng)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/extract", body)
        assert ei.value.code == 503
    finally:
        srv.shutdown()
        srv.server_close()


def test_abandoned_queued_job_never_reaches_device():
    """A job that 504s while still queued behind a wedged batch is queue
    congestion (no worker restart) and is dropped at batch commit, so the
    device never runs it."""
    service = TopazService(device_timeout=60.0, batch_window_ms=0.0, **BASE)
    calls = []
    release = threading.Event()

    def fake_process(paths, batch_size=None, **kw):
        calls.append(list(paths))
        if len(calls) == 1:
            release.wait(timeout=60)
        return [(p, np.zeros(1, np.float32), np.zeros((1, 2), int)) for p in paths]

    service.pipe.process = fake_process
    try:
        results = {}
        t1 = threading.Thread(target=lambda: results.update(a=service.extract("job1")))
        t1.start()
        for _ in range(500):
            if calls:
                break
            time.sleep(0.01)
        assert calls, "worker never picked up job1"
        service.device_timeout = 0.3
        with pytest.raises(_Timeout):
            service.extract("job2")
        assert service.n_worker_restarts == 0 and service.n_timeouts == 1
        service.device_timeout = 60.0
        release.set()
        t1.join(timeout=30)
        assert not t1.is_alive() and len(results["a"][0]) == 1
        s3, _ = service.extract("job3")
        assert len(s3) == 1
        assert all("job2" not in batch for batch in calls), calls
        assert service._worker.is_alive() and not service._suspect_workers()
    finally:
        release.set()
        service.close()


def test_denoise_batch_stops_for_abandoned_jobs(tmp_path, rng):
    """A denoise job 504'd while an earlier shape group of its batch runs
    is skipped before its own device call."""
    p1, p2 = tmp_path / "a.mrc", tmp_path / "b.mrc"
    mrc.write(str(p1), rng.normal(0, 1, (32, 32)).astype(np.float32))
    mrc.write(str(p2), rng.normal(0, 1, (48, 48)).astype(np.float32))
    service = TopazService(**BASE)
    service.close()  # drive _run_denoise_batch directly
    j1, j2 = _Job("denoise", str(p1)), _Job("denoise", str(p2))

    class FakeDenoiser:
        calls = 0

        def denoise(self, x, patch_size=0):
            FakeDenoiser.calls += 1
            j2.abandoned = True  # j2's submitter 504s during group 1
            return torch.tensor(x)

        def denoise_batch(self, xs):
            FakeDenoiser.calls += 1
            j2.abandoned = True
            return torch.tensor(xs)

    service._denoiser = FakeDenoiser()
    service._run_denoise_batch([j1, j2])
    assert FakeDenoiser.calls == 1
    assert j1.done.is_set() and j1.error is None
    assert not j2.done.is_set()


def _loader_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("ThreadPoolExecutor") or "run" in t.name}


def test_a_sticky_device_error_answers_500_and_leaves_no_loader_thread(tmp_path, rng):
    """A device error that every later call repeats (as a CUDA illegal
    address does) fails each request with 500, without a hang, and stops
    the pipeline's loader threads each time."""
    from topaz_tpu_torch.utils.retry import is_transient_device_error

    service = TopazService(**BASE)
    srv, base = _start(service)
    err = RuntimeError("CUDA error: an illegal memory access was encountered")
    assert not is_transient_device_error(err)

    def broken(*a, **kw):
        raise err

    try:
        _, body = _micrograph_bytes(tmp_path, rng)
        _post(base + "/extract", body)  # warm: the threads a healthy run leaves
        before = _loader_threads()
        service.pipe._fn_for = lambda bucket: broken
        for _ in range(3):
            t0 = time.time()
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + "/extract", body)
            assert ei.value.code == 500 and time.time() - t0 < 60
            assert "illegal memory access" in json.loads(ei.value.read())["error"]
        for _ in range(100):
            if _loader_threads() <= before:
                break
            time.sleep(0.05)
        assert _loader_threads() <= before
        assert _get_json(base + "/healthz")["worker_alive"]
    finally:
        _stop(srv, service)


def test_sigterm_shuts_serve_down_cleanly(tmp_path, rng, monkeypatch):
    """``serve`` in the main thread: SIGTERM, sent in process once a request
    has been answered, takes the ^C path; it returns 0 with the listener
    closed, the worker stopped and the previous handler back."""
    from topaz_tpu_torch import serve as serve_mod
    from topaz_tpu_torch.cli.commands import serve as serve_cmd

    made = {}
    real_make_server = serve_mod.make_server

    def capture(service, host, port):
        made["server"] = real_make_server(service, host=host, port=port)
        made["service"] = service
        return made["server"]

    monkeypatch.setattr(serve_mod, "make_server", capture)
    _, body = _micrograph_bytes(tmp_path, rng)
    answered = {}

    def client():
        for _ in range(600):
            if "server" in made:
                break
            time.sleep(0.05)
        base = f"http://127.0.0.1:{made['server'].server_address[1]}"
        answered["extract"] = json.loads(_post(base + "/extract", body)[2])
        os.kill(os.getpid(), signal.SIGTERM)

    args = serve_cmd.add_arguments().parse_args(
        ["--port", "0", "-m", "resnet8_u32", "-s", "1", "-r", "6", "-t", "1.0", "-d", "cpu"])
    before = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=client)
    t.start()
    assert serve_mod.serve_from_args(args) == 0
    t.join(timeout=60)
    assert not t.is_alive() and answered["extract"]["count"] >= 1
    assert signal.getsignal(signal.SIGTERM) is before
    assert not made["service"]._worker.is_alive()
    assert made["server"].socket.fileno() == -1


def test_serve_cli_registration():
    from topaz_tpu_torch.cli.main import build_parser

    args = build_parser().parse_args(["serve", "--port", "0", "-m", "resnet8_u32", "-s", "4",
                                      "-t", "-5", "--fast"])
    assert args.port == 0 and args.scale == 4 and args.fast and args.device == 0


@pytest.mark.parametrize("argv,message", [
    (["serve", "--port", "0"], "no CUDA device"),
    (["serve", "--port", "0", "-d", "-1"], "no CUDA device"),
    (["serve", "--port", "0", "-d", "-2"], "no CUDA device"),
])
def test_serve_cli_refuses_without_cuda_or_with_every_device(monkeypatch, argv, message):
    from topaz_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert message in str(e.value.code)
