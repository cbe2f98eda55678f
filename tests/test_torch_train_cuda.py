"""Training on the card against training on the CPU, and the crop gather's
build.

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_train_cuda.py``. Without a card its card tests skip. The
same weights (drawn from a CPU generator), crops and labels go through
three Adam steps on each device. The metrics of each step agree to rtol
1e-3, atol 1e-5 (cuDNN and the CPU sum float32 in other orders; TF32 is
off). The weights agree to 2 lr a step: Adam moves each weight by about lr
in the direction of m / sqrt(v), which the sum order can flip where the
gradient is near zero."""

import os

import numpy as np
import pytest
import torch

from topaz_tpu_torch.models.factory import new_picker
from topaz_tpu_torch.train.methods import make_loss_fn
from topaz_tpu_torch.train.trainer import init_train_state, make_train_step


LR = 2e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the train step on the card")
    return torch.device("cuda")


def _run(device, crops, labels, bn):
    model = new_picker("resnet8", units=32, bn=bn, seed=0, device=device)
    state = init_train_state(model, 0.05, lr=LR, seed=0)
    loss_fn, header, _ = make_loss_fn("GE-binomial", 0.05)
    step = make_train_step(loss_fn)
    rows = []
    for c, y in zip(crops, labels):
        m = step(state, torch.from_numpy(c).to(device), torch.from_numpy(y).to(device))
        rows.append([float(m[h]) for h in header if h != "adjusted_precision"])
    return np.array(rows), {k: v.cpu() for k, v in model.state_dict().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [False, True])
def test_train_steps_on_the_card_match_the_cpu(cuda_device, bn):
    rng = np.random.default_rng(0)
    crops = rng.normal(size=(3, 64, 71, 71)).astype(np.float32)
    labels = (rng.random((3, 64)) < 0.1).astype(np.float32)
    got_rows, got = _run(cuda_device, crops, labels, bn)
    want_rows, want = _run(torch.device("cpu"), crops, labels, bn)
    np.testing.assert_allclose(got_rows, want_rows, rtol=1e-3, atol=1e-5)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=2 * LR * len(crops), msg=k)


def test_crop_gather_builds_into_the_port():
    from topaz_tpu_torch import _build
    from topaz_tpu_torch.train.cropgather import gather_crops, load_library

    lib = load_library()
    assert os.path.dirname(lib._name) == _build.BUILD_DIR
    image = np.arange(30, dtype=np.float32).reshape(5, 6)
    out = gather_crops(image, np.array([-1, 3]), np.array([0, 4]), 3)
    np.testing.assert_array_equal(out[0], [[0, 0, 0], [0, 1, 2], [6, 7, 8]])
    np.testing.assert_array_equal(out[1], [[22, 23, 0], [28, 29, 0], [0, 0, 0]])
