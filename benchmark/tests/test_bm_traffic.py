"""Each traffic generator gives the same inputs for a seed."""

import os

import numpy as np
import torch

from harness import inputs, spec


def _traffics():
    b = spec.load()
    return {w["traffic"]: spec.Cell(b, w["name"]).traffic for w in b["workloads"]}


def _small(traffic):
    cams = [dict(c, shape=[c["shape"][0] // 16, c["shape"][1] // 16], files=min(2, c["files"]))
            for c in traffic["cameras"]]
    return cams, dict(traffic["micrograph"], particle_radius_px=6)


def test_bm_micrographs_follow_the_seed():
    for name, t in _traffics().items():
        cams, p = _small(t)
        a = inputs.micrograph_set(cams, p, 2**31 + 11, "cpu")
        b = inputs.micrograph_set(cams, p, 2**31 + 11, "cpu")
        c = inputs.micrograph_set(cams, p, 2**31 + 12, "cpu")
        assert [n for n, _ in a] == [n for n, _ in b], name
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b)), name
        assert not all(torch.equal(x, y) for (_, x), (_, y) in zip(a, c)), name
        for cam, (_, img) in zip([c for c in cams for _ in range(c["files"])], a):
            assert tuple(img.shape) == tuple(cam["shape"]) and img.dtype == torch.float32


def test_bm_mrc_round_trip(tmp_path):
    img = np.random.default_rng(0).normal(size=(37, 53)).astype(np.float32)
    path = os.path.join(tmp_path, "a.mrc")
    inputs.write_mrc(path, img)
    assert np.array_equal(inputs.read_mrc(path), img)
    assert os.path.getsize(path) == 1024 + img.nbytes
