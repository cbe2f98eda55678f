"""The port's ``watch`` against the JAX package's, on the CPU.

Seeded 128^2 micrographs with planted particles go through both watchers
(``resnet8_u32``, ``scale=1, radius=6, threshold=1.0``, batch 2, ``once``)
into separate outputs, then a restart with new files. With both pipelines
real, the picks must be identical in coordinates and order, scores within
rtol 1e-4 (XLA and PyTorch sum float32 convolutions in other orders). For
the files, the port's watcher replays the picks the JAX pipeline gave, so
that the writers see the same numbers: the appended table and the
per-micrograph ``star`` and ``box`` files must then be byte-equal (numbers
formatted as the JAX package formats a numpy int and a numpy float32, one
header across restarts), and the manifests must list the same files at the
same sizes. JAX's watcher builds a pipeline each call; the module hands it
one instance, so its programs compile once for the file. Then the JAX
package's behaviour tests, on the port alone: stability polls, recursion,
live arrival with denoised previews and raw-pixel coordinates, the
transient-error requeue, SIGTERM, the CLI and its refusals."""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from topaz_tpu import pipeline as jax_pipeline
from topaz_tpu.watch import watch_directory as jax_watch_directory
from topaz_tpu_torch.cli.main import main
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.watch import DirectoryWatcher, watch_directory
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(model="resnet8_u32", scale=1, radius=6, threshold=1.0, batch_size=2,
          poll_interval=0.01, once=True)


def _write_micrograph(path, rng, shape=(128, 128), peaks=((40, 40), (90, 80))):
    x = rng.normal(0, 1, shape).astype(np.float32)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    for cy, cx in peaks:
        x -= 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 3.0**2)).astype(np.float32)
    mrc.write(str(path), x)


@pytest.fixture(scope="module")
def jax_picks():
    """JAX's ``watch_directory`` builds a ``MicrographPipeline`` each call;
    give every call with the same keywords one instance, and record what
    it yields by path."""
    real = jax_pipeline.MicrographPipeline
    made, recorded = {}, {}

    def cached(**kw):
        key = repr(sorted(kw.items()))
        if key not in made:
            pipe = made[key] = real(**kw)
            process = pipe.process

            def recording(paths, **pkw):
                for result in process(paths, **pkw):
                    recorded[result[0]] = result
                    yield result

            pipe.process = recording
        return made[key]

    patch = pytest.MonkeyPatch()
    patch.setattr(jax_pipeline, "MicrographPipeline", cached)
    yield recorded
    patch.undo()


class _Replay:
    """Stands in for the port's pipeline: yields the JAX pipeline's
    recorded results for the paths asked, in their order."""

    recorded: dict = {}

    def __init__(self, **kw):
        pass

    def process(self, paths, batch_size=None):
        for p in paths:
            yield self.recorded[p]


def _both(tmp_path, d, output, jax_picks=None, **kw):
    """Run JAX's watcher, then the port's on ``d`` (replaying JAX's picks
    when ``jax_picks`` is given); returns {tag: (output path, count)}."""
    import topaz_tpu_torch.pipeline as port_pipeline

    outs = {tag: str(tmp_path / tag / output) for tag in ("jax", "port")}
    n_jax = jax_watch_directory(str(d), outs["jax"], **KW, **kw)
    with pytest.MonkeyPatch.context() as patch:
        if jax_picks is not None:
            patch.setattr(_Replay, "recorded", jax_picks)
            patch.setattr(port_pipeline, "MicrographPipeline", _Replay)
        n_port = watch_directory(str(d), outs["port"], **KW, **kw, device="cpu")
    return {"jax": (outs["jax"], n_jax), "port": (outs["port"], n_port)}


def _table(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines.count("image_name\tx_coord\ty_coord\tscore") == 1
    rows = [ln.split("\t") for ln in lines[1:]]
    return ([(r[0], int(r[1]), int(r[2])) for r in rows],
            np.array([float(r[3]) for r in rows]))


def _manifest(path):
    with open(path) as f:
        return json.load(f)["processed"]


def _acquisition(d, rng, first: int):
    for i in range(first):
        _write_micrograph(d / f"mic{i}.mrc", rng)


def _arrivals(d, rng, first: int):
    _write_micrograph(d / f"mic{first}.mrc", rng, peaks=((60, 60),))
    _write_micrograph(d / f"mic{first + 1}.mrc", rng, peaks=((30, 100), (100, 30)))


def test_picks_match_jax_across_a_restart(tmp_path, jax_picks):
    d = tmp_path / "in"
    d.mkdir()
    rng = np.random.default_rng(42)
    _acquisition(d, rng, 3)
    first = _both(tmp_path, d, "picks.txt")
    assert first["port"][1] == first["jax"][1] == 3
    _arrivals(d, rng, 3)
    second = _both(tmp_path, d, "picks.txt")
    assert second["port"][1] == second["jax"][1] == 2
    got, got_scores = _table(second["port"][0])
    want, want_scores = _table(second["jax"][0])
    assert got == want
    assert {r[0] for r in got} == {f"mic{i}" for i in range(5)}
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-4, atol=1e-5)


def test_appended_table_byte_equal_to_jax_across_a_restart(tmp_path, jax_picks):
    d = tmp_path / "in"
    d.mkdir()
    rng = np.random.default_rng(43)
    _acquisition(d, rng, 3)
    first = _both(tmp_path, d, "picks.txt", jax_picks)
    assert first["port"][1] == first["jax"][1] == 3
    _arrivals(d, rng, 3)
    second = _both(tmp_path, d, "picks.txt", jax_picks)
    assert second["port"][1] == second["jax"][1] == 2
    port, jax = second["port"][0], second["jax"][0]
    with open(port, "rb") as f:
        got = f.read()
    with open(jax, "rb") as f:
        assert got == f.read()
    assert len(got.decode().splitlines()) > 6
    assert _manifest(port + ".manifest.json") == _manifest(jax + ".manifest.json")
    assert len(_manifest(port + ".manifest.json")) == 5


@pytest.mark.parametrize("fmt", ["star", "box"])
def test_per_micrograph_files_byte_equal_to_jax(tmp_path, jax_picks, fmt):
    d = tmp_path / "in"
    d.mkdir()
    rng = np.random.default_rng(7)
    _acquisition(d, rng, 2)
    kw = dict(per_micrograph=True, out_format=fmt, suffix="_topaz")
    _both(tmp_path, d, "picks", jax_picks, **kw)
    _write_micrograph(d / "mic2.mrc", rng, peaks=((60, 60),))
    outs = _both(tmp_path, d, "picks", jax_picks, **kw)
    assert outs["port"][1] == outs["jax"][1] == 1
    port_dir, jax_dir = outs["port"][0], outs["jax"][0]
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir))
    files = [n for n in names if n.endswith("." + fmt)]
    assert files == [f"mic{i}_topaz.{fmt}" for i in range(3)]
    for name in files:
        with open(os.path.join(port_dir, name), "rb") as f:
            got = f.read()
        with open(os.path.join(jax_dir, name), "rb") as f:
            assert got == f.read(), name
        assert len(got) > 0
    assert (_manifest(os.path.join(port_dir, "watch.manifest.json"))
            == _manifest(os.path.join(jax_dir, "watch.manifest.json")))


def test_directory_watcher_stability_and_manifest(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    manifest = str(tmp_path / "m.json")
    (d / "a.mrc").write_bytes(b"x" * 100)
    (d / "ignored.txt").write_bytes(b"y")

    w = DirectoryWatcher(str(d), manifest_path=manifest)
    assert w.scan() == []  # first sighting: stability unknown
    assert w.scan() == [str(d / "a.mrc")]  # size unchanged -> stable
    (d / "b.mrc").write_bytes(b"x" * 10)
    assert w.scan() == []
    (d / "b.mrc").write_bytes(b"x" * 20)  # grew
    assert w.scan() == []
    assert w.scan() == [str(d / "b.mrc")]  # settled at 20 bytes
    w.mark_done(str(d / "a.mrc"))
    w.mark_done(str(d / "b.mrc"))
    w.save_manifest()
    assert w.scan() == []
    w2 = DirectoryWatcher(str(d), manifest_path=manifest)  # a restart
    assert w2.scan() == [] and w2.scan() == []
    assert set(os.path.basename(k) for k in _manifest(manifest)) == {"a.mrc", "b.mrc"}
    # requeue: an offered file comes back on the next scan
    (d / "c.mrc").write_bytes(b"z" * 5)
    assert w2.scan() == [] and w2.scan() == [str(d / "c.mrc")]
    assert w2.scan() == []
    w2.requeue([str(d / "c.mrc")])  # offered again once stable again
    assert w2.scan() == [] and w2.scan() == [str(d / "c.mrc")]


def test_watcher_recursive_nested_dirs(tmp_path):
    d = tmp_path / "in"
    (d / "GridSquare_1" / "Data").mkdir(parents=True)
    (d / "GridSquare_1" / "Data" / "a.mrc").write_bytes(b"x" * 50)
    flat = DirectoryWatcher(str(d))
    assert flat.scan() == [] and flat.scan() == []
    w = DirectoryWatcher(str(d), recursive=True)
    assert w.scan() == []
    assert w.scan() == [str(d / "GridSquare_1" / "Data" / "a.mrc")]
    (d / "GridSquare_2").mkdir()
    (d / "GridSquare_2" / "b.mrc").write_bytes(b"y" * 10)
    assert w.scan() == []
    assert w.scan() == [str(d / "GridSquare_2" / "b.mrc")]


def test_live_arrival_denoise_and_upscale(tmp_path):
    """Files appearing while watching are processed on later polls, with
    denoised previews and coordinates in raw pixels (scale 2)."""
    rng = np.random.default_rng(3)
    d = tmp_path / "in"
    d.mkdir()
    _write_micrograph(d / "first.mrc", rng)
    out = str(tmp_path / "picks.txt")
    den_dir = str(tmp_path / "den")
    polls = {"n": 0}

    def hook():
        polls["n"] += 1
        if polls["n"] == 4:
            _write_micrograph(d / "late.mrc", rng, peaks=((64, 64),))
        return polls["n"] <= 8

    n = watch_directory(str(d), out, model="resnet8_u32", denoise_model="fcnn",
                        denoised_dir=den_dir, scale=2, radius=3, threshold=1.0,
                        poll_interval=0.01, device="cpu", _poll_hook=hook)
    assert n == 2
    with open(out) as f:
        rows = [ln.split("\t") for ln in f.read().strip().splitlines()[1:]]
    assert {r[0] for r in rows} == {"first", "late"}
    xy = np.array([[int(r[1]), int(r[2])] for r in rows])
    assert 64 < xy.max() < 128  # raw pixels, not the 64-wide working frame
    for name in ("first", "late"):
        den = mrc.read(os.path.join(den_dir, name + ".mrc"))[0]
        assert den.shape == (64, 64) and np.isfinite(den).all()
    assert watch_directory(str(d), out, model="resnet8_u32", scale=2, radius=3,
                           threshold=1.0, poll_interval=0.01, once=True, device="cpu") == 0


def test_transient_device_error_requeues_the_batch(tmp_path, monkeypatch):
    """A transient failure that outlasts the pipeline's own retry requeues
    the poll's files; the next poll processes them."""
    from topaz_tpu_torch.pipeline import MicrographPipeline

    rng = np.random.default_rng(4)
    d = tmp_path / "in"
    d.mkdir()
    _write_micrograph(d / "m0.mrc", rng)
    real = MicrographPipeline.process
    calls = []

    def flaky(self, paths, batch_size=None, prefetch=2):
        calls.append(list(paths))
        if len(calls) == 1:
            raise RuntimeError("UNAVAILABLE: connection reset by peer")
        return real(self, paths, batch_size=batch_size, prefetch=prefetch)

    monkeypatch.setattr(MicrographPipeline, "process", flaky)
    polls = {"n": 0}

    def hook():
        polls["n"] += 1
        return polls["n"] <= 6

    out = str(tmp_path / "p.txt")
    n = watch_directory(str(d), out, model="resnet8_u32", scale=1, radius=6, threshold=1.0,
                        poll_interval=0.01, device="cpu", _poll_hook=hook)
    assert n == 1 and len(calls) == 2
    assert str(d / "m0.mrc") in _manifest(out + ".manifest.json")


def test_sigterm_shuts_down_watch_cleanly(tmp_path):
    """SIGTERM, sent in process from the poll hook, takes the ^C path:
    watch returns with the manifest saved, and the previous SIGTERM handler
    is back afterwards."""
    rng = np.random.default_rng(5)
    d = tmp_path / "in"
    d.mkdir()
    _write_micrograph(d / "mic0.mrc", rng)
    out = str(tmp_path / "picks.txt")
    polls = {"n": 0}

    def hook():
        polls["n"] += 1
        if polls["n"] > 4:  # the backlog went on poll 2
            os.kill(os.getpid(), signal.SIGTERM)
        return True

    before = signal.getsignal(signal.SIGTERM)
    n = watch_directory(str(d), out, model="resnet8_u32", scale=1, radius=6, threshold=1.0,
                        poll_interval=0.01, device="cpu", _poll_hook=hook)
    assert n == 1
    assert signal.getsignal(signal.SIGTERM) is before
    assert str(d / "mic0.mrc") in _manifest(out + ".manifest.json")


def test_watch_in_a_worker_thread_installs_no_handler(tmp_path):
    rng = np.random.default_rng(6)
    d = tmp_path / "in"
    d.mkdir()
    _write_micrograph(d / "mic0.mrc", rng)
    before = signal.getsignal(signal.SIGTERM)
    seen, result = [], {}

    def hook():
        seen.append(signal.getsignal(signal.SIGTERM))
        return True

    def run():
        result["n"] = watch_directory(str(d), str(tmp_path / "p.txt"), model="resnet8_u32",
                                      scale=1, radius=6, threshold=1.0, poll_interval=0.01,
                                      once=True, device="cpu", _poll_hook=hook)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and result["n"] == 1
    assert seen and all(h is before for h in seen)


def test_sigterm_as_interrupt_unit():
    from topaz_tpu_torch.utils.signals import sigterm_as_interrupt

    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(KeyboardInterrupt):
        with sigterm_as_interrupt():
            os.kill(os.getpid(), signal.SIGTERM)
            signal.sigtimedwait  # noqa: B018 - any bytecode delivers it
    assert signal.getsignal(signal.SIGTERM) is before
    errs = []

    def body():
        try:
            with sigterm_as_interrupt():
                pass
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and errs == []


def test_watch_cli_runs_on_the_cpu(tmp_path):
    rng = np.random.default_rng(8)
    d = tmp_path / "in"
    d.mkdir()
    _write_micrograph(d / "m0.mrc", rng)
    out = str(tmp_path / "picks.txt")
    main(["watch", str(d), "-o", out, "-m", "resnet8_u32", "-s", "1", "-r", "6", "-t", "1.0",
          "--poll-interval", "0.01", "--once", "-d", "cpu"])
    with open(out) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "image_name\tx_coord\ty_coord\tscore"
    assert len(lines) > 1 and lines[1].startswith("m0\t")


def test_watch_cli_flags_resolve():
    from topaz_tpu_torch.cli.commands import watch as watch_cmd
    from topaz_tpu_torch.cli.fast import apply_fast

    args = watch_cmd.add_arguments().parse_args(
        ["in", "-o", "picks/", "--per-micrograph", "--format", "star", "--suffix", "_topaz",
         "--fast"])
    assert args.per_micrograph and args.out_format == "star" and args.suffix == "_topaz"
    apply_fast(args)
    assert args.precision == "bf16" and args.bins == 65536


@pytest.mark.parametrize("device", [[], ["-d", "-1"]])
def test_watch_cli_without_cuda_exits_with_an_error(tmp_path, monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["watch", str(tmp_path), "-o", str(tmp_path / "p.txt"), "--once"] + device)
    assert "no CUDA device" in str(e.value.code)
    assert not os.path.exists(tmp_path / "p.txt")
