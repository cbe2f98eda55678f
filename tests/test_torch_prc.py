"""``precision_recall_curve`` of the port against the JAX CLI's: stdout
byte-equal (the '# auprc=..., mae=...' line and the tab-separated table)
for each ``--images`` mode, with images missing on either side."""

import numpy as np
import pytest

from topaz_tpu.cli.commands import precision_recall_curve as jprc
from topaz_tpu_torch.cli.main import main as tmain


def _files(tmp_path, integer_names=False):
    rng = np.random.default_rng(0)
    names = ["101", "102", "103", "104"] if integer_names else ["mic_a", "mic_b", "mic_c",
                                                                 "mic_d"]
    targets, predicted = [], []
    # mic_a and mic_b in both; mic_c only in the targets; mic_d only predicted
    for name in names[:3]:
        for _ in range(int(rng.integers(5, 12))):
            targets.append((name, int(rng.integers(0, 200)), int(rng.integers(0, 200))))
    for name in names[:2] + names[3:]:
        tx = [(x, y) for n, x, y in targets if n == name]
        for x, y in tx[: len(tx) - 2]:  # most targets found, off by a pixel or two
            predicted.append((name, x + int(rng.integers(-2, 3)), y + int(rng.integers(-2, 3))))
        for _ in range(6):  # and some false picks
            predicted.append((name, int(rng.integers(0, 200)), int(rng.integers(0, 200))))
    scores = rng.normal(size=len(predicted)).astype(np.float32)
    scores[3] = scores[7]  # a tie pools into one bucket
    with open(tmp_path / "targets.txt", "w") as f:
        print("image_name\tx_coord\ty_coord", file=f)
        for row in targets:
            print("\t".join(str(v) for v in row), file=f)
    with open(tmp_path / "predicted.txt", "w") as f:
        print("image_name\tx_coord\ty_coord\tscore", file=f)
        for row, s in zip(predicted, scores):
            print("\t".join(str(v) for v in row) + f"\t{s}", file=f)
    return str(tmp_path / "targets.txt"), str(tmp_path / "predicted.txt")


@pytest.mark.parametrize("images", ["target", "predicted", "union"])
@pytest.mark.parametrize("radius", [3, 1])
@pytest.mark.parametrize("integer_names", [False, True])
def test_precision_recall_curve_stdout_is_the_jax_clis(tmp_path, capsys, images, radius,
                                                        integer_names):
    targets, predicted = _files(tmp_path, integer_names)
    argv = ["--predicted", predicted, "--targets", targets, "-r", str(radius),
            "--images", images]
    jprc.main(jprc.add_arguments().parse_args(argv))
    want = capsys.readouterr().out
    tmain(["precision_recall_curve"] + argv)
    got = capsys.readouterr().out
    assert got == want
    assert got.startswith("# auprc=") and "threshold\tprecision\trecall\tf1\n" in got
    assert len(got.splitlines()) > 10


@pytest.mark.parametrize("n,ties", [(1000, False), (5000, True), (1, False)])
def test_average_precision_on_tensors_equals_the_host_version(n, ties):
    """Training's evaluation computes the AUPRC on the device: the same tie
    buckets as the host version, within float64 rounding."""
    import torch

    from topaz_tpu.ops.metrics import average_precision as j_average_precision
    from topaz_tpu_torch.ops.metrics import average_precision, average_precision_tensor

    rng = np.random.default_rng(n)
    pred = rng.normal(size=n).astype(np.float32)
    if ties:
        pred = np.round(pred, 1)  # many equal scores
    target = (rng.random(n) < 0.3).astype(np.float32)
    target[0] = 1.0
    want = j_average_precision(target, pred)
    assert average_precision(target, pred) == want
    got = average_precision_tensor(torch.from_numpy(target), torch.from_numpy(pred))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    got_n = average_precision_tensor(torch.from_numpy(target), torch.from_numpy(pred), N=n)
    np.testing.assert_allclose(got_n, j_average_precision(target, pred, N=n), rtol=1e-12)
