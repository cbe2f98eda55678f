#!/usr/bin/env python3
"""Where a 3D picker training step spends its time on one NVIDIA GPU, and
how far training rows of the card and the CPU drift apart (the
PyTorch/CUDA port, topaz_tpu_torch).

    python3 tools/profile_torch_train.py

1. One warm step of ``train --dims 3`` at the CLI's width (resnet8, units
   32, GE-binomial, batch 256 of 71^3 crops), f32 with TF32 off as the port
   runs it: CUDA events around 5 steps, then ``torch.profiler`` by operator
   and input shape; and, for comparison only, the same with
   ``cudnn.benchmark`` on (the port leaves it off).
2. Card against CPU, the commands of ``chip_smoke.py``'s checks: ``train
   --dims 3 --no-pretrained`` for 5 steps at batch 8 on a 48 x 96 x 96 crop
   of its training tomogram (phase ``train3d``), then at batch 64; ``train
   --autoencoder 1 --ngf 32`` for 5 steps at batch 64 on its 12 training
   micrographs (phase ``train_ae``), and the same without
   ``--autoencoder`` (phase ``training``). Each on the CPU once and on the
   card three times, the third with ``cudnn.deterministic``. The largest
   difference a row, in units of max(|cpu|, 1e-2), against the CPU and
   between the card's runs.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def step_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from topaz_tpu_torch.models.factory import new_picker
    from topaz_tpu_torch.train.methods import make_loss_fn
    from topaz_tpu_torch.train.trainer import init_train_state, make_train_step

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(256, 71, 71, 71, device="cuda", generator=g)
    y = (torch.rand(256, device="cuda", generator=g) < 0.0625).float()
    state = init_train_state(new_picker("resnet8", units=32, dims=3, seed=0, device="cuda"),
                             0.0006)
    step = make_train_step(make_loss_fn("GE-binomial", 0.0006)[0])
    bound_ms = cs.train_step_flops(state.model.spec, 256) / cs.F32_OPS_PER_S * 1e3
    for benchmark in (False, True):
        torch.backends.cudnn.benchmark = benchmark
        ms = cs.cuda_ms(lambda: step(state, x, y), iters=5, warmup=3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            step(state, x, y)
            torch.cuda.synchronize()
        print(f"# step, batch 256 of 71^3, cudnn.benchmark {benchmark}: {ms:.3f} ms "
              f"(CUDA events around 5 steps), bound {bound_ms:.3f} ms")
        print(prof.key_averages(group_by_input_shape=True).table(
            sort_by="self_device_time_total", row_limit=12, max_name_column_width=50,
            max_shapes_column_width=70))
    torch.backends.cudnn.benchmark = False


def drift(workdir: str, tag: str, argv) -> None:
    """Rows of ``argv`` (one epoch of 5 steps) on the CPU and three times
    on the card; the largest difference a row against the CPU and between
    the card's runs."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from topaz_tpu_torch.cli.main import main as cli

    def rows(device, run, deterministic=False):
        log = os.path.join(workdir, f"{tag}_{run}.tsv")
        torch.backends.cudnn.deterministic = deterministic
        try:
            cli(argv + ["-d", device, "-o", log])
        finally:
            torch.backends.cudnn.deterministic = False
        _, table = cs.read_log(log)
        return np.array([r[3:-1] for r in table if r[2] == "train"], dtype=float)

    def diff(a, b):
        rel = np.abs(a - b) / np.maximum(np.abs(b), cs.TRAIN_TOL_FLOOR)
        return [f"{d:.3e}" for d in rel.max(axis=1)]

    cpu = rows("cpu", "cpu")
    card = [rows("0", "card1"), rows("0", "card2"), rows("0", "det", deterministic=True)]
    print(f"# {tag}: largest difference a row, card vs cpu {diff(card[0], cpu)}, "
          f"{diff(card[1], cpu)}; card vs card {diff(card[1], card[0])}; with "
          f"cudnn.deterministic vs cpu {diff(card[2], cpu)}")


def card_vs_cpu():
    import numpy as np

    import chip_smoke as cs
    from topaz_tpu_torch.io import mrc

    with tempfile.TemporaryDirectory() as workdir:
        _, tomo, centers, n_labeled = cs.write_tomogram_split(workdir, "train3d",
                                                              cs.SEED + 400, 2 / 3)
        crop_dir = os.path.join(workdir, "crop3d")
        os.makedirs(crop_dir)
        mrc.write(os.path.join(crop_dir, "crop.mrc"),
                  np.ascontiguousarray(mrc.read(tomo)[0][:48, :96, :96]))
        inside = [i for i, (z, y, x) in enumerate(centers) if z < 48 and y < 96 and x < 96]
        targets = os.path.join(crop_dir, "targets.txt")
        with open(targets, "w") as f:
            print("image_name\tx_coord\ty_coord\tz_coord", file=f)
            for i in inside:
                if i < n_labeled:
                    z, y, x = centers[i]
                    print(f"crop\t{x}\t{y}\t{z}", file=f)
        for batch in (8, 64):
            drift(workdir, f"train3d batch {batch}", [
                "train", "--dims", "3", "--no-pretrained", "--train-images", crop_dir,
                "--train-targets", targets, "-n", str(len(inside)), "-r", "3",
                "--num-epochs", "1", "--epoch-size", "5", "--minibatch-size", str(batch)])

    with tempfile.TemporaryDirectory() as workdir:
        images, targets = cs.write_training_set(workdir)["train"]
        argv = ["train", "--train-images", images, "--train-targets", targets, "-n",
                str(cs.TRAIN_PARTICLES), "-r", "3", "--num-epochs", "1", "--epoch-size", "5",
                "--minibatch-size", "64"]
        drift(workdir, "train_ae batch 64", argv + ["--autoencoder", "1", "--ngf", "32"])
        drift(workdir, "train (2D) batch 64", argv)


def main() -> None:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("no CUDA device available")
    print(f"# card: {cs.card_line()}")
    step_profile()
    card_vs_cpu()


if __name__ == "__main__":
    main()
