"""Two processes joined by ``torch.distributed`` (gloo, on the CPU) take one
data-parallel train step, each feeding its own local batch over two
in-process data shards, as the JAX package's tests/test_multihost.py does
with its 2 x 4 virtual devices. Both must come out with the weights of one
process's step on the whole batch (the two local batches concatenated in
rank order): within 1e-5 relative, atol 1e-8, and the loss within 1e-5
relative (the same float32 sums in other orders). With batch norm the
statistics are the global batch's, over both shards of both processes, and
the running statistics match too. Each process has its own time limit, so
a hang fails the test instead of stalling the suite."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from topaz_tpu_torch.models.factory import new_picker, picker_to_numpy
from topaz_tpu_torch.train.methods import make_loss_fn
from topaz_tpu_torch.train.trainer import init_train_state, make_train_step
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B_LOCAL = 4

WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from topaz_tpu_torch.parallel.devices import maybe_distributed_init
assert maybe_distributed_init() and maybe_distributed_init()
import torch.distributed as dist
from topaz_tpu_torch.models.factory import new_picker, picker_to_numpy
from topaz_tpu_torch.parallel.mesh import make_dp_train_step, make_mesh
from topaz_tpu_torch.train.methods import make_loss_fn
from topaz_tpu_torch.train.trainer import init_train_state, make_train_step

rank = dist.get_rank()
assert dist.get_world_size() == 2
model = new_picker("resnet8", units=4, bn=sys.argv[2] == "bn", seed=0, device="cpu")
state = init_train_state(model, 0.05, lr=2e-4)
step = make_dp_train_step(make_loss_fn("GE-binomial", 0.05)[0],
                          make_mesh(2, 1, ["cpu", "cpu"]))
rng = np.random.default_rng(rank)
crops = rng.normal(size=(%(b)d, 71, 71)).astype(np.float32)
labels = (np.arange(%(b)d) %% 2 == 0).astype(np.float32)
metrics = step(state, torch.from_numpy(crops), torch.from_numpy(labels))
params, model_state = picker_to_numpy(model)
params = {**params, "model_state": model_state}
out = {}
def walk(prefix, tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            walk(prefix + k + "/", v)
        else:
            out[prefix + k] = np.asarray(v)
walk("", params)
out["loss"] = np.asarray(float(metrics["loss"]))
# the step made without distributed=True trains this process alone
alone = init_train_state(new_picker("resnet8", units=4, bn=sys.argv[2] == "bn", seed=0,
                                    device="cpu"), 0.05, lr=2e-4)
out["loss_alone"] = np.asarray(float(make_train_step(make_loss_fn("GE-binomial", 0.05)[0])(
    alone, torch.from_numpy(crops), torch.from_numpy(labels))["loss"]))
np.savez(sys.argv[1], **out)
dist.destroy_process_group()
print("MHOST-OK", rank, float(metrics["loss"]), flush=True)
''' % {"b": B_LOCAL}


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, prefix + k + "/") if isinstance(v, dict) else
                   {prefix + k: np.asarray(v)})
    return out


@pytest.mark.parametrize("bn", [False, True])
def test_two_process_dp_step_equals_one_process_step(tmp_path, bn):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, outs = [], []
    for rank in range(2):
        env = dict(os.environ, TOPAZ_COORDINATOR=f"127.0.0.1:{port}",
                   TOPAZ_NUM_PROCESSES="2", TOPAZ_PROCESS_ID=str(rank), PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1")
        outs.append(str(tmp_path / f"rank{rank}.npz"))
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER, outs[-1],
                                       "bn" if bn else "-"], env=env,
                                      cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            assert "MHOST-OK" in out, out + err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    # one process, one device, the whole batch
    model = new_picker("resnet8", units=4, bn=bn, seed=0, device="cpu")
    state = init_train_state(model, 0.05, lr=2e-4)
    crops = np.concatenate([np.random.default_rng(r).normal(size=(B_LOCAL, 71, 71))
                            for r in range(2)]).astype(np.float32)
    labels = np.tile((np.arange(B_LOCAL) % 2 == 0).astype(np.float32), 2)
    metrics = make_train_step(make_loss_fn("GE-binomial", 0.05)[0])(
        state, torch.from_numpy(crops), torch.from_numpy(labels))
    params, model_state = picker_to_numpy(model)
    want = _flat({**params, "model_state": model_state})
    for rank, path in enumerate(outs):
        alone = init_train_state(new_picker("resnet8", units=4, bn=bn, seed=0, device="cpu"),
                                 0.05, lr=2e-4)
        loss_alone = make_train_step(make_loss_fn("GE-binomial", 0.05)[0])(
            alone, torch.from_numpy(crops[rank * B_LOCAL:(rank + 1) * B_LOCAL]),
            torch.from_numpy(labels[:B_LOCAL]))["loss"]
        with np.load(path) as got:
            np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-5)
            np.testing.assert_allclose(float(got["loss_alone"]), float(loss_alone), rtol=1e-5)
            assert sorted(k for k in got.files if not k.startswith("loss")) == sorted(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-8, err_msg=k)
