"""Picker training: data statistics, pi, the epoch loop, evaluation and
checkpoints (port of topaz_tpu/training.py:35-518, the reference's
topaz/training.py), for 2D micrographs and 3D tomograms, with the optional
autoencoder regularizer, without pandas.

The stdout/stderr contract is the reference's:
  * '# source split p_observed ...' data-statistics lines from the MRC
    headers only (training.py:279-295);
  * pi <- pi - p_observed for the GE methods, and PN when pi <= p_observed
    (training.py:352-400);
  * TSV rows 'epoch iter split <method metrics> auprc' with '-' for what a
    split lacks (training.py:571-603), and one picker checkpoint an epoch,
    in the JAX package's .npz layout.
The sampler runs in a producer thread; the steps run on the device; each
train row's metrics are copied out in one non-blocking copy right after
their step and printed a few steps later, so the host never waits for the
device inside an epoch. In 3D the producer draws only the windows'
positions, and the windows are cut on the device from the tomograms
uploaded once (``train.data.ResidentVolumes``).
"""

from __future__ import annotations

import copy
import os
import sys
import tempfile
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from topaz_tpu_torch.parallel.devices import data_mesh_for, resolve_devices
from topaz_tpu_torch.io import coordinates as file_utils
from topaz_tpu_torch.io.coordinates import Coordinates
from topaz_tpu_torch.io.image import load_image
from topaz_tpu_torch.io.mrc import HEADER_SIZE, parse_header
from topaz_tpu_torch.models.factory import load_picker, new_picker, save_picker
from topaz_tpu_torch.models.generative import generator_width, init_generator
from topaz_tpu_torch.models.tiling import classify_patches_3d
from topaz_tpu_torch.ops.masks import as_mask
from topaz_tpu_torch.ops.metrics import average_precision_tensor
from topaz_tpu_torch.preprocess import calculate_pi, pixels_given_radius
from topaz_tpu_torch.train.data import CropSampler, ResidentVolumes, find_image_paths
from topaz_tpu_torch.train.methods import bce_with_logits, make_loss_fn
from topaz_tpu_torch.train.partition import kfold
from topaz_tpu_torch.train.trainer import (
    init_train_state, is_jax_state, load_train_state, make_train_step, save_train_state)
from topaz_tpu_torch.transfer import fetch_later
from topaz_tpu_torch.utils.batching import iterate_prefetched
from topaz_tpu_torch.utils.printing import report
from topaz_tpu_torch.utils.profiling import stage


def _name(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def group_paths_by_source(images_path: str, targets: Coordinates,
                          image_ext: str = "") -> List[List[str]]:
    """Image paths grouped by 'source', sources in sorted order
    (topaz/training.py:69-91): the image list's own column, else the first
    source of the image's targets (images without one are left out), else
    one source."""
    images = find_image_paths(images_path, image_ext)
    if "source" in images:
        sources = images["source"].tolist()
    elif targets.source is not None:
        by_image = targets.source_by_image()
        sources = [by_image.get(n) for n in images["image_name"]]
    else:
        sources = [0] * len(images["path"])
    groups: Dict[object, List[str]] = {}
    for source, path in zip(sources, images["path"]):
        if source is not None:
            groups.setdefault(source, []).append(path)
    return [groups[s] for s in sorted(groups)]


def extract_image_stats(image_paths: List[List[str]], targets: Coordinates,
                        mode: str = "train", radius: int = 3,
                        dims: int = 2) -> Tuple[int, int]:
    """Positive and total regions from the MRC headers only
    (training.py:251-276)."""
    num_positive_regions = 0
    total_regions = 0
    pixels_per_particle = pixels_given_radius(radius, dims)
    counts: Dict[str, int] = {}
    for name in targets.image_name:
        counts[name] = counts.get(name, 0) + 1
    for source, source_paths in enumerate(image_paths):
        source_positive = 0
        source_total = 0
        for path in source_paths:
            with open(path, "rb") as f:
                header = parse_header(f.read(HEADER_SIZE))
            source_total += int(header.nz) * int(header.ny) * int(header.nx)
            source_positive += counts.get(_name(path), 0) * pixels_per_particle
        p_observed = source_positive / source_total
        report(f"{source}\t{mode}\t{p_observed:.5e}\t{source_positive}\t{source_total}")
        num_positive_regions += source_positive
        total_regions += source_total
    return num_positive_regions, total_regions


def report_data_stats(train_images_path: str, train_targets_path: str,
                      test_images_path: Optional[str] = None,
                      test_targets_path: Optional[str] = None, radius: int = 3,
                      dims: int = 2, image_ext: str = "", format: str = "auto"):
    """Positives, pixels and images from the MRC headers only
    (training.py:279-295)."""
    report("source\tsplit\tp_observed\tnum_positive_regions\ttotal_regions")
    train_targets = file_utils.read_coordinates(train_targets_path, format=format)
    train_grouped = group_paths_by_source(train_images_path, train_targets, image_ext)
    num_train_images = sum(len(g) for g in train_grouped)
    num_positive, total = extract_image_stats(train_grouped, train_targets, mode="train",
                                              radius=radius, dims=dims)
    if test_images_path is not None and test_targets_path is not None:
        test_targets = file_utils.read_coordinates(test_targets_path, format=format)
        test_grouped = group_paths_by_source(test_images_path, test_targets, image_ext)
        extract_image_stats(test_grouped, test_targets, mode="test", radius=radius,
                            dims=dims)
    return num_positive, total, num_train_images


def make_model_from_args(args, device):
    """The picker to train, on ``device``: a checkpoint given to --model, the
    bundled pretrained weights of the same configuration, or fresh weights
    (topaz/training.py:298-349). Every bundled picker is 2D, so a 3D run
    with --pretrained warns that its weights are unavailable and starts
    from fresh ones, where the JAX package loads the 2D weights into a 3D
    run that then fails at its first step."""
    report("Loading model:", args.model)
    if args.model.endswith(".sav") or args.model.endswith(".npz"):
        return load_picker(args.model, device=device)

    report(f"Model parameters: units={args.units}, dropout={args.dropout}, bn={args.bn}")
    flag = None
    if args.pretrained:
        flag = {("resnet8", 32): "resnet8_u32", ("resnet8", 64): "resnet8_u64",
                ("resnet16", 32): "resnet16_u32",
                ("resnet16", 64): "resnet16_u64"}.get((args.model, args.units))
    if flag is not None:
        try:
            if args.dims != 2:
                raise FileNotFoundError(f"{flag} is a 2D picker")
            report("Loading pretrained model:", flag)
            return load_picker(flag, device=device)
        except FileNotFoundError:
            report(f"WARNING: pretrained weights for {flag} unavailable; "
                   f"initializing randomly")
    return new_picker(args.model, units=args.units, bn=(args.bn == "on"),
                      dropout=args.dropout, pooling=args.pooling,
                      unit_scaling=args.unit_scaling, dims=args.dims,
                      seed=getattr(args, "seed", 0), device=device)


def adjust_method(method: str, pi: Optional[float], p_observed: float):
    """pi adjustment and the PN fallback of the GE methods
    (training.py:352-374)."""
    if pi is not None and pi <= p_observed and method in ("GE-KL", "GE-binomial"):
        print(f"WARNING: pi={pi} but the observed fraction of positives is "
              f"{p_observed} and method is set to {method}.", file=sys.stderr)
        print(f"WARNING: setting method to PN with pi={p_observed} instead.",
              file=sys.stderr)
        print(f"WARNING: if you meant to use {method}, please set pi > "
              f"{p_observed}.", file=sys.stderr)
        return "PN", p_observed
    if pi is not None and method in ("GE-KL", "GE-binomial"):
        return method, pi - p_observed
    return method, pi


def evaluate_model(model, test_paths: List[str], test_targets: Coordinates,
                   radius: int = 3):
    """Dense whole-image evaluation (topaz/training.py:506-548): mean
    per-pixel BCE, precision, TPR, FPR and AUPRC against the targets
    rasterized at ``radius`` (with their z_coord for a tomogram). A
    tomogram is scored in tiles (``classify_patches_3d``), which equals
    one dense pass within float32 and keeps the activations of a 192 x 384
    x 384 tomogram at full width out of memory. The scores stay on the
    model's device, where the metrics are computed (sums in float64)."""
    device = model.classifier_w.device
    n = 0
    loss = 0.0
    scores, y_true = [], []
    for path in test_paths:
        img = np.array(load_image(path), dtype=np.float32)
        t = test_targets.for_image(_name(path))
        z = t.z_coord if img.ndim == 3 else None
        mask = torch.from_numpy(as_mask(img.shape, radius, t.x_coord, t.y_coord,
                                        z_coord=z).ravel()).to(device)
        with torch.no_grad():
            if img.ndim == 3:
                score = classify_patches_3d(model, img).reshape(-1)
            else:
                score = model(torch.from_numpy(img).to(device)[None])[0].reshape(-1)
            this_loss = bce_with_logits(score, mask).mean()
        n += 1
        loss += (float(this_loss) - loss) / n
        scores.append(score)
        y_true.append(mask)

    scores = torch.cat(scores)
    y_true = torch.cat(y_true)
    y_hat = torch.sigmoid(scores).to(torch.float64)
    positive = y_true == 1
    precision = float(y_hat[positive].sum() / y_hat.sum())
    tpr = float(y_hat[positive].mean())
    fpr = float(y_hat[~positive].mean())
    auprc = average_precision_tensor(y_true, scores)
    return loss, precision, tpr, fpr, auprc


class _LaggedRows:
    """Train rows fetched a few steps behind their step: each row's metrics
    start for the host right after the step (``transfer.fetch_later``); a
    row is read once ``depth`` newer rows wait, or at the end of the epoch,
    waiting only for its own copy."""

    def __init__(self, print_row, depth: int):
        self.print_row, self.depth = print_row, depth
        self.pending: deque = deque()

    def push(self, epoch: int, it: int, packed: torch.Tensor) -> None:
        self.pending.append((epoch, it, fetch_later(packed)))
        if len(self.pending) > self.depth:
            self._pop()

    def _pop(self) -> None:
        epoch, it, row = self.pending.popleft()
        self.print_row(epoch, it, row.result().tolist())

    def flush(self) -> None:
        while self.pending:
            self._pop()


def train_model(args, output=None):
    """End-to-end training (topaz/training.py:606-647 and fit_epochs);
    returns the final ``TrainState``."""
    output = output or sys.stdout
    if args.autoencoder > 0 and args.dims != 2:
        # the JAX package's decoder and its target are 2D; its 3D step fails
        # on broadcasting (4, 31, 31, 31) against (4, 31, 31)
        raise ValueError("the autoencoder regularizer (--autoencoder > 0) is 2D only; "
                         "train a 3D picker (--dims 3) without it")
    devices = resolve_devices(args.device)
    device = devices[0]
    # -d -2: data-parallel over every device (and over processes when
    # TOPAZ_COORDINATOR joined them), the minibatch split over them
    mesh = None
    if args.device == -2:
        mesh = data_mesh_for(devices, args.minibatch_size, warn=True)
        if mesh is not None:
            report(f"Data-parallel training over {mesh.shape['data']} devices")

    model = make_model_from_args(args, device)
    report("Receptive field:", model.spec.width)

    num_positive, total_regions, num_images = report_data_stats(
        args.train_images, args.train_targets, args.test_images, args.test_targets,
        radius=args.radius, dims=args.dims, image_ext=args.image_ext,
        format=args.format_)

    if args.num_particles > 0:
        expected = args.num_particles * num_images
        pi = calculate_pi(expected, args.radius, total_regions, args.dims)
        report(f"Specified expected number of particle per micrograph = "
               f"{args.num_particles}")
        report(f"With radius = {args.radius}")
        report(f"Setting pi = {pi}")
    else:
        pi = args.pi
        report(f"pi = {pi}")
    if pi is None and args.method in ("GE-KL", "GE-binomial", "PU"):
        raise ValueError(f"method {args.method} requires pi: set --pi or give the "
                         f"expected particles per micrograph with -n/--num-particles")

    p_observed = num_positive / total_regions
    method, pi_adj = adjust_method(args.method, pi, p_observed)
    loss_fn, header, split = make_loss_fn(
        method, pi_adj, slack=args.slack,
        entropy_penalty=getattr(args, "entropy_penalty", 0.0),
        momentum=getattr(args, "ge_momentum", 1.0), beta=getattr(args, "pu_beta", 0.0))

    est_max_prec = p_observed / pi if pi else 1.0
    report("Estimated max precision given pi and p_observed:", est_max_prec)
    report("If your adjusted precision is greater than 1.0 (especially on a "
           "test split), you have likely set pi too high.")
    report(f"minibatch_size={args.minibatch_size}, epoch_size={args.epoch_size}, "
           f"num_epochs={args.num_epochs}")

    train_targets = file_utils.read_coordinates(args.train_targets, format=args.format_)
    train_grouped = group_paths_by_source(args.train_images, train_targets, args.image_ext)
    train_paths = [p for group in train_grouped for p in group]
    seed = getattr(args, "seed", 0)
    # several processes: each samples its own crops (one seed would repeat
    # one local batch in every process)
    sampler_seed = seed
    if args.device == -2 and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        sampler_seed += 1000003 * torch.distributed.get_rank()
    sampler = CropSampler(train_paths, train_targets, model.spec.width, radius=args.radius,
                          split=split, rotate=(args.dims == 2 or args.augment3d),
                          seed=sampler_seed, dims=args.dims)
    report(f"Loaded {sampler.num_images} training micrographs with "
           f"~{int(sampler.num_pixels // sampler.mask_size)} labeled particles")

    test_paths = test_targets = None
    if args.test_images is not None and args.test_targets is not None:
        test_targets = file_utils.read_coordinates(args.test_targets, format=args.format_)
        test_paths = find_image_paths(args.test_images, args.image_ext)["path"].tolist()
        report(f"Loaded {len(test_paths)} testing micrographs with "
               f"{len(test_targets)} labeled particles")

    balance = (num_positive / total_regions) if args.natural else args.minibatch_balance

    # the autoencoder regularizer (topaz/training.py:339-345); its weights
    # come from seed + 1 as the JAX package's do, but from torch's generator
    decoder = None
    if args.autoencoder > 0:
        depth = int(np.log2(model.spec.width + 1) - 3)
        decoder = init_generator(model.spec.latent_dim, torch.Generator().manual_seed(seed + 1),
                                 units=args.ngf, depth=depth).to(device)
        at = 2 if "ge_penalty" in header else 1
        header = header[:at] + ["recon_error"] + header[at:]
        report(f"Generator: units={args.ngf}, size={generator_width(depth)}")

    state = init_train_state(model, pi_adj, lr=args.learning_rate, seed=seed, decoder=decoder)
    # across processes only at -d -2, as the JAX package: at -d N each process trains alone
    step_fn = make_train_step(loss_fn, l2=args.l2, autoencoder=args.autoencoder, mesh=mesh,
                              distributed=args.device == -2)

    # --resume: the whole training state and the sampler's stream, so the
    # run continues bit-exactly, mid-epoch included (the reference's resume
    # is weights-only, topaz/training.py:301-304)
    start_epoch, start_step, it = 1, 0, 1
    if getattr(args, "resume", None):
        rmeta = load_train_state(args.resume, state)
        it = rmeta["iter"]
        start_epoch = rmeta["epoch"]
        start_step = rmeta["steps_in_epoch"]
        if start_step >= args.epoch_size or start_step == 0:
            start_epoch += 1
            start_step = 0
        if rmeta.get("sampler_rng"):
            sampler.rng.bit_generator.state = rmeta["sampler_rng"]
        report(f"Resuming at epoch {start_epoch}"
               + (f" step {start_step + 1}" if start_step else "") + f" (iter {it})")
        if is_jax_state(rmeta):
            report("The JAX package's step key does not carry over: dropout and on-device "
                   f"augmentation draw from this run's seed ({seed}); weights, optimizer, "
                   "objective and the sampler's stream continue")

    save_steps = int(getattr(args, "save_interval_steps", 0) or 0)
    state_path = (args.save_prefix + "_train_state.npz"
                  if args.save_prefix is not None else None)

    print("\t".join(["epoch", "iter", "split"] + header + ["auprc"]), file=output,
          flush=True)
    prec_idx = header.index("precision")
    plain_cols = [h for h in header if h != "adjusted_precision"]

    def print_row(epoch, it, row):
        row.insert(prec_idx + 1, row[prec_idx] / est_max_prec)
        print(f"{epoch}\t{it}\ttrain\t" + "\t".join(str(v) for v in row) + "\t-",
              file=output, flush=True)

    def save_state(epoch, steps_in_epoch, rng_state):
        if state_path is None:
            return
        os.makedirs(os.path.dirname(state_path) or ".", exist_ok=True)
        save_train_state(state_path, state, epoch, it, steps_in_epoch,
                         sampler_rng_state=rng_state)

    pin = device.type == "cuda"
    volumes = ResidentVolumes(sampler, device) if args.dims == 3 else None
    rows = _LaggedRows(print_row, depth=int(os.environ.get("TOPAZ_METRIC_LAG", "8")))
    for epoch in range(start_epoch, args.num_epochs + 1):
        n_steps = args.epoch_size - (start_step if epoch == start_epoch else 0)

        def producer(n=n_steps):
            # the sampler's state is captured after each draw, so a
            # mid-epoch checkpoint resumes on exactly the next batch; the
            # positive count is Binomial(B, balance) from the sampler's own
            # stream (memory_mapped_data.py:210-216)
            for _ in range(n):
                n_pos = (int(sampler.rng.binomial(args.minibatch_size, balance))
                         if balance else 0)
                if volumes is not None:  # positions now, windows on the device
                    *crops, labels = sampler.sample_positions(args.minibatch_size, n_pos)
                else:
                    crops, labels = sampler.sample_batch(args.minibatch_size, n_pos)
                    crops = torch.from_numpy(crops)
                    crops = crops.pin_memory() if pin else crops
                labels = torch.from_numpy(labels)
                labels = labels.pin_memory() if pin else labels
                yield crops, labels, copy.deepcopy(sampler.rng.bit_generator.state)

        step_in_epoch = start_step if epoch == start_epoch else 0
        rng_state = None
        with stage("train_epoch"):
            for crops, labels, rng_state in iterate_prefetched(producer, maxsize=4):
                crops = (volumes.gather(*crops) if volumes is not None
                         else crops.to(device, non_blocking=True))
                metrics = step_fn(state, crops, labels.to(device, non_blocking=True))
                rows.push(epoch, it, torch.stack([metrics[h] for h in plain_cols]))
                it += 1
                step_in_epoch += 1
                if save_steps and step_in_epoch % save_steps == 0 \
                        and step_in_epoch < args.epoch_size:
                    save_state(epoch, step_in_epoch, rng_state)
            rows.flush()

        if test_paths:
            with stage("train_evaluate"):
                loss, prec, tpr, fpr, auprc = evaluate_model(
                    model, test_paths, test_targets, radius=args.radius)
            adjusted = prec / est_max_prec
            dashes = "\t".join(["-"] * (len(header) - 5))
            dashes = "\t" + dashes + "\t" if dashes else "\t"
            print(f"{epoch}\t{it}\ttest\t{loss}{dashes}{prec}\t{adjusted}\t"
                  f"{tpr}\t{fpr}\t{auprc}", file=output, flush=True)

        if args.save_prefix is not None:
            digits = int(np.ceil(np.log10(max(args.num_epochs, 2))))
            path = args.save_prefix + f"_epoch{epoch:0{digits}}.npz"
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            save_picker(path, model, decoder)
            save_state(epoch, 0, rng_state)
    return state


def train_from_args(args):
    """CLI entry (topaz/commands/train.py main contract)."""
    if args.describe:
        print(make_model_from_args(args, resolve_devices(args.device)[0]).spec)
        sys.exit()

    if args.k_fold > 1 and args.test_images is None:
        _apply_kfold_split(args)

    if args.output is not None:
        out_dir = os.path.dirname(args.output)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
    output = sys.stdout if args.output is None else open(args.output, "w")
    report("Training...")
    try:
        result = train_model(args, output=output)
    finally:
        if args.output is not None:
            output.close()
    report("Done!")
    return result


def _apply_kfold_split(args) -> None:
    """Split the training micrographs into train and test folds
    (topaz/training.py:191-223), written as list files into a temporary
    directory that the args then name."""
    targets = file_utils.read_coordinates(args.train_targets, format=args.format_)
    grouped = group_paths_by_source(args.train_images, targets, args.image_ext)
    counts: Dict[str, int] = {}
    for name in targets.image_name:
        counts[name] = counts.get(name, 0) + 1
    rows = [{"source": source, "image_name": _name(path), "path": path,
             "count": counts.get(_name(path), 0)}
            for source, paths in enumerate(grouped) for path in paths]
    random = np.random.RandomState(args.cross_validation_seed)
    train_rows, test_rows = list(kfold(args.k_fold, rows, random=random))[args.fold]
    report(f"Split into {len(train_rows)} train and {len(test_rows)} test micrographs")

    tmpdir = tempfile.mkdtemp(prefix="topaz_kfold_")

    def write_split(split_rows, tag):
        img_list = os.path.join(tmpdir, f"images_{tag}.txt")
        with open(img_list, "w") as f:
            print("image_name\tpath", file=f)
            for r in split_rows:
                print(f"{r['image_name']}\t{r['path']}", file=f)
        names = {r["image_name"] for r in split_rows}
        tgt = targets.take(np.array([n in names for n in targets.image_name], dtype=bool))
        tgt_list = os.path.join(tmpdir, f"targets_{tag}.txt")
        with open(tgt_list, "w") as f:
            file_utils.write_tsv(f, tgt, tgt.columns)
        return img_list, tgt_list

    args.train_images, args.train_targets = write_split(train_rows, "train")
    args.test_images, args.test_targets = write_split(test_rows, "test")
