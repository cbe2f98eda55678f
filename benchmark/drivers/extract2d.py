"""Closed loop through ``extract.extract_particles`` at batch size 1, the
call ``topaz extract`` makes at its defaults: whole passes over preprocessed
micrographs written as MRC files in set-up, each pass one call on every
file in a seeded order, which loads the picker once, then reads, uploads,
scores and suppresses one micrograph at a time and writes its picks into
the pass's table in the work directory.

The configuration's ``picker_seeded`` gives the model (its arch, width and
layer list; not ``picker``, whose weights the reference would load from
the repository) and ``path`` the downsampling, the radius, the batch size
and the threshold's rank. The weights are drawn from the seed at the
published layer shapes and written in set-up as an ``.npz`` in the JAX
layout (kernels HWIO), which the program loads by path and the reference
reads itself. The threshold is the score of the ``threshold_rank``-th pick
that greedy NMS takes, with no threshold, from the warm micrograph's map:
fixed for the run.

Traffic keys: ``cameras`` (the frames, ``files`` distinct ones of each
shape, made as ``harness/inputs.micrograph_set`` makes them from
``micrograph``), ``warm_passes`` (whole passes before the window).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from harness import check as judge, inputs
from reference import model as ref_model, nms as ref_nms, prep


def layers(units: int) -> List[dict]:
    """ResNet16's layer list at ``units`` (topaz/model/features/resnet.py
    ResNet16, widths [u, 2u, 4u]): a 7^2 convolution, seven ResidA blocks at
    dilation 1 (the first and the fifth at stride 2, the fifth widening
    through a 1^2 projection), a 5^2 convolution."""
    u = [units, 2 * units, 4 * units]

    def resid(cin, cout, stride):
        return {"op": "resid", "cin": cin, "hidden": cin, "cout": cout, "stride": stride,
                "dilation": 1}

    return ([{"op": "conv", "k": 7, "cin": 1, "cout": u[0], "stride": 1, "dilation": 1},
             resid(u[0], u[0], 2)] + [resid(u[0], u[0], 1)] * 3
            + [resid(u[0], u[1], 2)] + [resid(u[1], u[1], 1)] * 2
            + [{"op": "conv", "k": 5, "cin": u[1], "cout": u[2], "stride": 1, "dilation": 1}])


def write_weights(path: str, model: dict, seed: int) -> None:
    """A checkpoint of ``model`` (the configuration's ``picker_seeded``)
    with weights drawn from ``seed``: each kernel uniform in
    +-sqrt(6 / fan_in), the He scale that keeps a ReLU network's
    activations at the input's size, each convolution's bias uniform in
    +-1/sqrt(fan_in), a residual block's 1^2 projection without a bias (as
    the bundled pickers hold it), and the 1^2 classifier's weights and bias
    uniform in +-1/sqrt(its inputs), as the program's ``init_picker`` draws
    them. Kernels are HWIO under ``params:features.<i>.<name>`` and
    ``params:classifier``; the meta is the program's checkpoint meta."""
    rng = inputs.host_rng(seed, "picker-weights")
    arrays = {}

    def conv(name, k, cin, cout, bias=True):
        fan_in = cin * k * k
        bound = math.sqrt(6.0 / fan_in)
        arrays[f"params:{name}w"] = rng.uniform(
            -bound, bound, size=(k, k, cin, cout)).astype(np.float32)
        if bias:
            arrays[f"params:{name}b"] = rng.uniform(
                -1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in), size=(cout,)).astype(np.float32)

    for i, layer in enumerate(model["layers"]):
        p = f"features.{i}."
        if layer["op"] == "conv":
            conv(p + "conv_", layer["k"], layer["cin"], layer["cout"])
        else:
            if layer["cin"] != layer["cout"]:
                conv(p + "proj_", 1, layer["cin"], layer["cout"], bias=False)
            conv(p + "conv0_", 3, layer["cin"], layer["hidden"])
            conv(p + "conv1_", 3, layer["hidden"], layer["cout"])
    latent = model["layers"][-1]["cout"]
    bound = 1 / math.sqrt(latent)
    arrays["params:classifier.w"] = rng.uniform(-bound, bound,
                                                size=(1, 1, latent, 1)).astype(np.float32)
    arrays["params:classifier.b"] = rng.uniform(-bound, bound, size=(1,)).astype(np.float32)
    meta = {"arch": model["arch"], "units": model["units"], "bn": bool(model["bn"]),
            "dims": model["dims"]}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def write_micrographs(traffic: dict, scale: int, seed: int, device, workdir: str) -> List[str]:
    """The traffic's frames, made on ``device`` as ``micrograph_set`` makes
    them, each Fourier-cropped by ``scale`` and standardized (mean 0,
    population std 1, taken in float64): ``preprocess -s <scale>``'s
    output shape, with a plain standardization in place of its GMM
    normalization. Written as float32 MRC files in ``workdir``; returns
    their paths, the first the warm micrograph."""
    paths = []
    for name, frame in inputs.micrograph_set(traffic["cameras"], traffic["micrograph"], seed,
                                             device):
        x = prep.fourier_crop(frame, scale).double()
        x = ((x - x.mean()) / x.std(correction=0)).float()
        path = os.path.join(workdir, name + ".mrc")
        inputs.write_mrc(path, x.cpu().numpy())
        paths.append(path)
        del frame, x
    return paths


def rank_threshold(scores_desc, rank: int) -> float:
    """The ``rank``-th highest of the scores of an unthresholded greedy
    NMS: a threshold that lets ``rank`` - 1 picks through on that map."""
    if len(scores_desc) < rank:
        raise ValueError(f"the threshold's rule needs {rank} picks; the map gave "
                         f"{len(scores_desc)}")
    return float(scores_desc[rank - 1])


def program_counters() -> Dict[str, int]:
    """The route's module counters: micrographs suppressed one at a time,
    pixels of their maps, NMS rounds (0 for a counter a program lacks)."""
    from topaz_tpu_torch import extract
    from topaz_tpu_torch.ops import nms

    return {"micrographs_picked": getattr(extract, "micrographs_picked", 0),
            "output_pixels": getattr(extract, "output_pixels", 0),
            "rounds": getattr(nms, "rounds", 0)}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.workdir = device, workdir
        path = config["path"]
        self.radius = int(path["radius"])
        self.batch_size = int(path["batch_size"])
        self.weights = os.path.join(workdir, config["picker_seeded"]["model"] + ".npz")
        self.tables: List[str] = []   # the window's pick tables, one a pass
        self.completed = 0
        self.attempted = 0
        self.pixels = 0               # score pixels of the completed micrographs
        self.threshold = None

    def modules(self) -> Dict[str, torch.nn.Module]:
        # the program's own extract/* spans are read, no hook of ours
        return {}

    def setup(self):
        # a program without the entry fails here, before any work
        from topaz_tpu_torch.extract import extract_particles, score_images
        from topaz_tpu_torch.ops.nms import non_maximum_suppression

        self.extract = extract_particles
        path = self.config["path"]
        write_weights(self.weights, self.config["picker_seeded"], self.seed)
        self.paths = write_micrographs(self.traffic, int(path["scale"]), self.seed, self.device,
                                       self.workdir)
        self.map_pixels = [inputs.read_mrc(p).size for p in self.paths]
        self.order_rng = inputs.host_rng(self.seed, "pass-order")
        _, score = next(score_images(self.weights, self.paths[:1], device=self.device))
        scores, _ = non_maximum_suppression(score, self.radius, device=score.device)
        self.threshold = rank_threshold(scores, int(path["threshold_rank"]))
        del score
        for k in range(int(self.traffic["warm_passes"])):
            self._pass(os.path.join(self.workdir, f"warm_{k}.txt"))

    def _pass(self, table: str) -> np.ndarray:
        order = self.order_rng.permutation(len(self.paths))
        self.extract([self.paths[i] for i in order], model=self.weights,
                     threshold=self.threshold, radius=self.radius, batch_size=self.batch_size,
                     output=table, device=self.device)
        return order

    def window(self, seconds: float) -> float:
        before = program_counters()
        t0 = time.perf_counter()
        while True:
            table = os.path.join(self.workdir, f"picks_{len(self.tables):04d}.txt")
            self.attempted += len(self.paths)
            order = self._pass(table)
            self.completed += len(order)
            self.pixels += sum(self.map_pixels[i] for i in order)
            self.tables.append(table)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                counted = {k: v - before[k] for k, v in program_counters().items()}
                print(f"extract2d: {self.completed} micrographs in {len(self.tables)} passes "
                      f"above {self.threshold!r}; the program's counters: {counted}",
                      file=sys.stderr)
                return elapsed

    def free(self):
        # each pass's call loaded its own picker and let it go
        pass


def read_answers(tables: Sequence[str], names: Sequence[str]) -> Dict[str, set]:
    """{image name: the distinct answers of the tables}, an answer the
    tuple of a micrograph's lines (x, y, score) as written; a micrograph
    with no line in a table answers the empty tuple there."""
    out = defaultdict(set)
    for table in tables:
        lines = defaultdict(list)
        with open(table) as f:
            next(f)  # the header
            for line in f:
                name, rest = line.rstrip("\n").split("\t", 1)
                lines[name].append(rest)
        unknown = set(lines) - set(names)
        if unknown:
            raise ValueError(f"{table}: picks of unknown micrographs {sorted(unknown)}")
        for name in names:
            out[name].add(tuple(lines.get(name, ())))
    return out


def parse_answer(answer: Tuple[str, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """(scores float32 (K,), coords (K, 2) as (x, y)) of an answer's lines;
    each score as written, float32's round-trip form, so read back exactly."""
    if not answer:
        return np.zeros(0, np.float32), np.zeros((0, 2), np.int64)
    cols = [line.split("\t") for line in answer]
    coords = np.array([[int(x), int(y)] for x, y, _ in cols], dtype=np.int64)
    scores = np.array([np.float32(s) for _, _, s in cols], dtype=np.float32)
    return scores, coords


class ReferenceMaps:
    """The plain reference's score maps of MRC files: ``reference/model.py``
    ``picker_scores`` of each file as written, with the checkpoint's
    weights, float32 with TF32 off (``tf32`` True: TF32 convolutions and
    matrix products, the control)."""

    def __init__(self, config: dict, weights: str, device, tf32: bool):
        self.layers = config["picker_seeded"]["layers"]
        self.w = ref_model.load_npz(weights, device)
        self.device, self.tf32 = device, tf32

    def __call__(self, path: str) -> torch.Tensor:
        x = torch.from_numpy(inputs.read_mrc(path).copy()).to(self.device)
        matmul = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                             allow_tf32=self.tf32):
                return ref_model.picker_scores(x[None], self.layers, self.w)[0]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul


def greedy_picks(S: torch.Tensor, r: int, t: float) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's greedy NMS picks of map ``S`` above ``t``: (scores
    by descending score, coords (K, 2) as (x, y))."""
    ys, xs = torch.nonzero(ref_nms.greedy_nms(S[None], r, t)[0], as_tuple=True)
    vals = S[ys, xs]
    order = torch.argsort(vals, descending=True, stable=True)
    coords = torch.stack([xs[order], ys[order]], dim=1)
    return vals[order].cpu().numpy(), coords.cpu().numpy()


def reference_threshold(S: torch.Tensor, r: int, rank: int) -> float:
    """The run's threshold rule on map ``S``: the ``rank``-th pick of the
    reference's greedy NMS with no threshold."""
    return rank_threshold(greedy_picks(S, r, -math.inf)[0], rank)


def check(driver: Driver, ref: judge.Reference):
    """Every answer of the window, each distinct one once, against the
    reference's map of its file, recomputed on the card, at the threshold
    the reference's own map of the warm micrograph gives by the run's rule:
    no judged number comes from the program."""
    r, rank = driver.radius, int(driver.config["path"]["threshold_rank"])
    maps = ReferenceMaps(driver.config, driver.weights, ref.device, ref.tf32)
    names = [os.path.splitext(os.path.basename(p))[0] for p in driver.paths]
    answers = read_answers(driver.tables, names)
    gaps = []
    t = None
    for name, path in zip(names, driver.paths):
        S = maps(path)
        if t is None:  # the warm micrograph comes first
            t = reference_threshold(S, r, rank)
            print(f"extract2d check: threshold {t!r} from the reference's map of the warm "
                  f"micrograph, {driver.threshold!r} from the program's", file=sys.stderr)
        for answer in answers[name]:
            scores, coords = parse_answer(answer)
            gaps.append(judge.pick_gap(S, scores, coords, r, t))
        print(f"extract2d check: {name}, {len(answers[name])} distinct answer(s) of "
              f"{sorted(len(a) for a in answers[name])} picks ({int((S > t).sum())} pixels "
              f"above the threshold): pick_gap {max(gaps[-len(answers[name]):])!r}",
              file=sys.stderr)
        del S
    return {"pick_gap": judge.worst(gaps), "missing": driver.attempted - driver.completed}, {}


def control(ref: judge.Reference, traffic: dict, seed: int, device, workdir: str):
    """The reference in TF32 in the program's place, on the cell's
    micrographs with the cell's weights: its threshold from its own map of
    the warm micrograph by the run's rule, its greedy picks of each
    micrograph judged as ``check`` judges the program's, against the
    float32 reference's maps at their threshold."""
    cfg = ref.cfg
    path = cfg["path"]
    r, rank = int(path["radius"]), int(path["threshold_rank"])
    weights = os.path.join(workdir, cfg["picker_seeded"]["model"] + ".npz")
    write_weights(weights, cfg["picker_seeded"], seed)
    paths = write_micrographs(traffic, int(path["scale"]), seed, device, workdir)
    low = ReferenceMaps(cfg, weights, device, True)
    want = ReferenceMaps(cfg, weights, device, False)
    t_low = reference_threshold(low(paths[0]), r, rank)
    t = reference_threshold(want(paths[0]), r, rank)
    gaps = []
    for p in paths:
        scores, coords = greedy_picks(low(p), r, t_low)
        gaps.append(judge.pick_gap(want(p), scores, coords, r, t))
    return {"pick_gap": judge.worst(gaps)}
