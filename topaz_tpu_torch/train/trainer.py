"""The training step: augment -> strided forward in train mode -> PU
objective -> backward -> update (port of topaz_tpu/train/trainer.py).

The JAX package compiles the whole step into one program; here it runs
eagerly on the model's device and stays there: nothing in a step waits for
the device, so the host queues steps ahead while the metrics are fetched
later. The optimizers are optax's update rules written out (``torch.optim``
puts adagrad's and rmsprop's eps elsewhere), and the L2 penalty is added to
the loss as 0.5 * l2 * sum(w^2) over every parameter, not as weight decay.
``save_train_state``/``load_train_state`` hold the whole state for
``--resume``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from topaz_tpu_torch.models.picker import Picker
from topaz_tpu_torch.train.augment import augment_crops
from topaz_tpu_torch.train.methods import MethodState, init_method_state

STATE_FORMAT = "topaz_tpu_torch.train_state.v1"


class Optimizer:
    """optax's adam, adagrad, sgd and rmsprop at their defaults
    (topaz_tpu/train/trainer.py:33-43), updating a parameter list in place:
      * adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
        corrected;
      * adagrad: accumulator from 0, update g / sqrt(acc + 1e-10), 0 where
        acc is 0;
      * sgd: plain, or with a momentum trace t = g + momentum t, whose
        update is t, or with ``nesterov`` g + momentum t;
      * rmsprop: decay 0.9, update g / sqrt(nu + 1e-8).
    ``weight_decay`` adds weight_decay * w to each gradient before the
    rule, as ``optax.chain(optax.add_decayed_weights(wd), opt)`` does."""

    KINDS = ("adam", "adagrad", "sgd", "rmsprop")

    def __init__(self, params: List[torch.Tensor], lr: float, kind: str = "adam",
                 momentum: float = 0.0, nesterov: bool = False, weight_decay: float = 0.0):
        if kind not in self.KINDS:
            raise ValueError(f"unknown optimizer: {kind}")
        if nesterov and not (kind == "sgd" and momentum):
            raise ValueError("nesterov needs sgd with momentum")
        self.params, self.lr, self.kind, self.momentum = params, lr, kind, momentum
        self.nesterov, self.weight_decay = nesterov, weight_decay
        self.count = 0
        n_slots = {"adam": 2, "adagrad": 1, "sgd": 1 if momentum else 0, "rmsprop": 1}[kind]
        self.slots = [[torch.zeros_like(p) for p in params] for _ in range(n_slots)]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        params, lr = self.params, self.lr
        self.count += 1
        if self.weight_decay > 0:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        if self.kind == "adam":
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu, nu = self.slots
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            denom = torch._foreach_div(nu, 1 - b2 ** self.count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(params, mu, denom, value=-lr / (1 - b1 ** self.count))
        elif self.kind == "adagrad":
            (acc,) = self.slots
            torch._foreach_addcmul_(acc, grads, grads)
            for p, g, a in zip(params, grads, acc):
                p.sub_(lr * torch.where(a > 0, g * torch.rsqrt(a + 1e-10), 0.0))
        elif self.kind == "sgd":
            if self.slots:
                (trace,) = self.slots
                torch._foreach_mul_(trace, self.momentum)
                torch._foreach_add_(trace, grads)
                grads = (torch._foreach_add(grads, trace, alpha=self.momentum)
                         if self.nesterov else trace)
            torch._foreach_add_(params, grads, alpha=-lr)
        else:
            (nu,) = self.slots
            torch._foreach_mul_(nu, 0.9)
            torch._foreach_addcmul_(nu, grads, grads, value=0.1)
            rms = torch._foreach_add(nu, 1e-8)
            torch._foreach_rsqrt_(rms)
            torch._foreach_mul_(rms, grads)
            torch._foreach_add_(params, rms, alpha=-lr)


def make_optimizer(params: List[torch.Tensor], lr: float, optim: str = "adam",
                   momentum: float = 0.0, nesterov: bool = False,
                   weight_decay: float = 0.0) -> Optimizer:
    """An optimizer by name (adam/adagrad/rmsprop/sgd) over ``params``."""
    return Optimizer(params, lr, optim, momentum, nesterov, weight_decay)


@dataclass
class TrainState:
    """Everything a step changes: the model (weights and batchnorm running
    statistics), the optimizer's slots, the objective's running state, and
    the generator of dropout and augmentation."""

    model: Picker
    optimizer: Optimizer
    method_state: MethodState
    generator: torch.Generator


def init_train_state(model: Picker, pi: Optional[float], lr: float = 2e-4,
                     optim: str = "adam", seed: int = 0) -> TrainState:
    """A fresh training state for ``model`` on its own device."""
    device = model.classifier_w.device
    return TrainState(model=model,
                      optimizer=make_optimizer(list(model.parameters()), lr, optim),
                      method_state=init_method_state(pi, device),
                      generator=torch.Generator(device=device).manual_seed(seed))


def make_train_step(loss_fn: Callable, l2: float = 0.0):
    """The train step ``step(state, crops, labels) -> metrics``: crops
    (B, S, S) and labels (B,) on the model's device. Crops of the receptive
    field go in as they are; larger ones (a raw-window sampler's) are
    augmented on the device first, rotated and flipped when at least
    sqrt(2) times the receptive field, else only center-cropped. The state
    is updated in place; the metrics stay on the device."""

    def step(state: TrainState, crops: torch.Tensor, labels: torch.Tensor) -> Dict:
        model = state.model
        crop = model.spec.width
        if crops.shape[1:] == (crop, crop):
            x = crops
        else:
            aug = crops.shape[-1] >= int(np.ceil(crop * np.sqrt(2)))
            x = augment_crops(crops, state.generator, crop, rotate=aug, flip=aug)
        score = model(x, dense=False, train=True, generator=state.generator).reshape(-1)
        loss, state.method_state, metrics = loss_fn(score, labels, state.method_state)
        if l2 > 0:
            loss = loss + 0.5 * l2 * sum(torch.sum(w ** 2) for w in state.optimizer.params)
        grads = torch.autograd.grad(loss, state.optimizer.params)
        state.optimizer.step(list(grads))
        return {k: v.detach() for k, v in metrics.items()}

    return step


# -- whole-state checkpoints (--resume) ---------------------------------------
#
# The reference's resume is weights-only (an epoch checkpoint given to
# --model restarts the optimizer cold). These files hold the whole state:
# weights, batchnorm statistics, optimizer slots and step count, the
# objective's running state, the step generator, and the host sampler's
# generator state as of the last consumed batch, so a resumed run continues
# on exactly the batch the uninterrupted run would have drawn next.

def save_train_state(path: str, state: TrainState, epoch: int, it: int,
                     steps_in_epoch: int, sampler_rng_state=None) -> None:
    """Write the whole training state (the port's own layout; its ``meta``
    keys are the JAX package's). ``steps_in_epoch`` = consumed steps of the
    (possibly unfinished) ``epoch``; 0 means the epoch completed."""
    arrays = {f"model.{k}": v.detach().cpu().numpy()
              for k, v in state.model.state_dict().items()}
    for i, slot in enumerate(state.optimizer.slots):
        for j, t in enumerate(slot):
            arrays[f"opt.{i}.{j}"] = t.cpu().numpy()
    arrays["method.running_expectation"] = state.method_state.running_expectation.cpu().numpy()
    arrays["generator"] = state.generator.get_state().numpy()
    meta = {"format": STATE_FORMAT, "epoch": int(epoch), "iter": int(it),
            "steps_in_epoch": int(steps_in_epoch), "opt_count": state.optimizer.count,
            "sampler_rng": sampler_rng_state}
    tmp = path + ".tmp.npz"  # the .npz suffix keeps np.savez from renaming it
    np.savez(tmp, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
             **arrays)
    os.replace(tmp, path)  # a crash mid-save never leaves a torn file


def load_train_state(path: str, state: TrainState) -> Dict:
    """Load a state written by ``save_train_state`` into ``state`` (built
    fresh for the same model, optimizer and method); returns the meta."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("format") != STATE_FORMAT:
            raise NotImplementedError(
                f"{path} is not a topaz_tpu_torch training state (a training state "
                f"of the JAX package, written by python -m topaz_tpu train?); resuming "
                f"from it is not yet ported to topaz_tpu_torch (ROADMAP P10)")
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    model_state = state.model.state_dict()
    want = {f"model.{k}": tuple(v.shape) for k, v in model_state.items()}
    for i, slot in enumerate(state.optimizer.slots):
        want.update({f"opt.{i}.{j}": tuple(t.shape) for j, t in enumerate(slot)})
    got = {k: tuple(v.shape) for k, v in arrays.items()
           if k.startswith(("model.", "opt."))}
    if got != want:
        raise ValueError(
            f"training state at {path} does not fit the current model, optimizer "
            f"and method flags; resume with those of the original run "
            f"(differing entries: {sorted(set(got.items()) ^ set(want.items()))[:6]})")
    state.model.load_state_dict({k: torch.from_numpy(arrays["model." + k])
                                 for k in model_state})
    with torch.no_grad():
        for i, slot in enumerate(state.optimizer.slots):
            for j, t in enumerate(slot):
                t.copy_(torch.from_numpy(arrays[f"opt.{i}.{j}"]))
        state.method_state.running_expectation.copy_(
            torch.from_numpy(arrays["method.running_expectation"]))
    state.optimizer.count = meta["opt_count"]
    state.generator.set_state(torch.from_numpy(arrays["generator"]))
    return meta
