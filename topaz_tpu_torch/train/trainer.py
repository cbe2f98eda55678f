"""The training step: augment -> strided forward in train mode -> PU
objective (+ the autoencoder's reconstruction error) -> backward -> update
(port of topaz_tpu/train/trainer.py).

The JAX package compiles the whole step into one program; here it runs
eagerly on the model's device and stays there: nothing in a step waits for
the device, so the host queues steps ahead while the metrics are fetched
later. The optimizers are optax's update rules written out (``torch.optim``
puts adagrad's and rmsprop's eps elsewhere), and the L2 penalty is added to
the loss as 0.5 * l2 * sum(w^2) over the picker's parameters (never the
decoder's, topaz/methods.py:63-67), not as weight decay.
``save_train_state``/``load_train_state`` hold the whole state for
``--resume``; ``load_train_state`` also reads the JAX package's states.
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from topaz_tpu_torch.models.factory import picker_from_numpy, picker_to_numpy
from topaz_tpu_torch.models.generative import (
    Generator, generator_from_numpy, generator_to_numpy)
from topaz_tpu_torch.models.picker import Picker
from topaz_tpu_torch.parallel.mesh import (Mesh, StatSync, gather_live, replicas, split_apply,
                                           summed_grads, sync_replicas, world)
from topaz_tpu_torch.train.augment import augment_crops, augment_crops_3d
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
    statistics), the autoencoder's decoder (None without one), the
    optimizer's slots (over the picker's parameters, then the decoder's),
    the objective's running state, and the generator of dropout and
    augmentation."""

    model: Picker
    optimizer: Optimizer
    method_state: MethodState
    generator: torch.Generator
    decoder: Optional[Generator] = None


def init_train_state(model: Picker, pi: Optional[float], lr: float = 2e-4,
                     optim: str = "adam", seed: int = 0,
                     decoder: Optional[Generator] = None) -> TrainState:
    """A fresh training state for ``model`` (and ``decoder``) on the
    model's device."""
    device = model.classifier_w.device
    params = list(model.parameters()) + (list(decoder.parameters()) if decoder else [])
    return TrainState(model=model, optimizer=make_optimizer(params, lr, optim),
                      method_state=init_method_state(pi, device),
                      generator=torch.Generator(device=device).manual_seed(seed),
                      decoder=decoder)


def augmented_crops(state: TrainState, crops: torch.Tensor) -> torch.Tensor:
    """The step's input: crops of the receptive field as they are; larger
    ones (a raw-window sampler's) augmented on the device with the state's
    generator, rotated and flipped when at least sqrt(2) times the
    receptive field, else only center-cropped."""
    crop, dims = state.model.spec.width, state.model.spec.dims
    if crops.shape[1:] == (crop,) * dims:
        return crops
    aug = crops.shape[-1] >= int(np.ceil(crop * np.sqrt(2)))
    augment = augment_crops_3d if dims == 3 else augment_crops
    return augment(crops, state.generator, crop, rotate=aug, flip=aug)


def recon_error_sum(state: TrainState, latent: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The autoencoder's squared error summed over each crop's center and
    over the batch (``recon_error`` times the batch size)."""
    crop = state.model.spec.width
    recon = state.decoder(latent.reshape(latent.shape[0], -1))
    width = recon.shape[-1]
    pad = (crop - width) // 2
    target = x[:, pad:pad + width, pad:pad + width]
    return torch.sum((target - recon).reshape(x.shape[0], -1) ** 2)


def l2_penalty(model: Picker, l2: float) -> torch.Tensor:
    """0.5 * l2 * sum(w^2) over the picker's parameters."""
    return 0.5 * l2 * sum(torch.sum(w ** 2) for w in model.parameters())


def make_train_step(loss_fn: Callable, l2: float = 0.0, autoencoder: float = 0.0,
                    mesh: Optional[Mesh] = None, distributed: bool = False):
    """The train step ``step(state, crops, labels) -> metrics``: crops
    (B, S, S), or (B, D, S, S) for a 3D picker, and labels (B,) on the
    model's device, augmented first (``augmented_crops``). With
    ``autoencoder > 0`` the state's decoder rebuilds the center of each crop
    from its latent and the loss adds ``autoencoder`` times the batch mean
    of the squared error summed over a crop (``recon_error``,
    topaz/methods.py:11-23). The state is updated in place; the metrics
    stay on the device.

    The crops are split over the data axis of ``mesh`` (one device, the
    model's, without one) and, with ``distributed`` while
    ``torch.distributed`` is initialized, over processes, each feeding its
    own local batch: one step on the whole (global) batch, as the JAX
    package's step is over its mesh. Each device forwards its share
    through its copy of the picker, batch norm takes its statistics over
    every share (``parallel/mesh.StatSync``), and the scores are gathered
    so that the objective sees the whole batch, also for the
    non-decomposable PU objectives. The copies' gradients are summed into
    the model's, all-reduced across processes (the L2 term enters on rank 0
    only), and one optimizer step is taken; the copies take the new
    weights at the next step. Dropout draws from each device's own
    generator (the state's on the first)."""
    dist, rank, n_proc = world() if distributed else (None, 0, 1)
    copies: Dict = {}
    generators: Dict = {}

    def step(state: TrainState, crops: torch.Tensor, labels: torch.Tensor) -> Dict:
        model = state.model
        primary = model.classifier_w.device
        devices = mesh.data_devices if mesh is not None else [primary]
        reps = replicas(model, devices, copies)
        sync_replicas(model, reps)
        x = augmented_crops(state, crops)

        def forward(i, dev, xb):
            gen = state.generator if i == 0 else generators.setdefault(
                i, torch.Generator(device=dev).manual_seed(1000003 * i))
            score, latent = reps[i](xb, dense=False, train=True, generator=gen,
                                    return_latent=True)
            return score.reshape(-1), latent

        score, latent = split_apply(forward, devices, x, out_device=primary, sync_stats=True,
                                    dist=dist)
        n = x.shape[0] * n_proc
        if n_proc > 1:
            score = gather_live(dist, n_proc, rank, score)
            labels = gather_live(dist, n_proc, rank, labels)
        loss, state.method_state, metrics = loss_fn(score, labels, state.method_state)
        if autoencoder > 0:
            # the decoder's batch norm sees every process's latents
            with (StatSync(1, dist).party(0) if n_proc > 1 else contextlib.nullcontext()):
                local = recon_error_sum(state, latent, x)
            total = local.detach().clone()
            if n_proc > 1:
                dist.all_reduce(total)
            loss = loss + local / n * autoencoder
            metrics = {**metrics, "recon_error": total / n}
        if l2 > 0 and rank == 0:
            loss = loss + l2_penalty(model, l2)
        grads = summed_grads(loss, state.optimizer.params, reps)
        if n_proc > 1:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            grads = [f.view_as(g) for f, g in zip(torch.split(flat, [g.numel() for g in grads]),
                                                  grads)]
        state.optimizer.step(grads)
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

def _module_arrays(state: TrainState) -> Dict[str, torch.Tensor]:
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    if state.decoder is not None:
        out.update({f"decoder.{k}": v for k, v in state.decoder.state_dict().items()})
    return out


def save_train_state(path: str, state: TrainState, epoch: int, it: int,
                     steps_in_epoch: int, sampler_rng_state=None) -> None:
    """Write the whole training state (the port's own layout; its ``meta``
    keys are the JAX package's). ``steps_in_epoch`` = consumed steps of the
    (possibly unfinished) ``epoch``; 0 means the epoch completed."""
    arrays = {k: v.detach().cpu().numpy() for k, v in _module_arrays(state).items()}
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
    """Load a state written by ``save_train_state``, or by the JAX
    package's (``is_jax_state``), into ``state`` (built fresh for the same
    model, decoder, optimizer and method); returns the meta."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    if is_jax_state(meta):
        _load_jax_state(path, arrays, meta, state)
        return meta
    modules = _module_arrays(state)
    want = {k: tuple(v.shape) for k, v in modules.items()}
    for i, slot in enumerate(state.optimizer.slots):
        want.update({f"opt.{i}.{j}": tuple(t.shape) for j, t in enumerate(slot)})
    got = {k: tuple(v.shape) for k, v in arrays.items()
           if k.startswith(("model.", "decoder.", "opt."))}
    if got != want:
        raise ValueError(
            f"training state at {path} does not fit the current model, optimizer "
            f"and method flags; resume with those of the original run "
            f"(differing entries: {sorted(set(got.items()) ^ set(want.items()))[:6]})")
    state.model.load_state_dict({k: torch.from_numpy(arrays["model." + k])
                                 for k in state.model.state_dict()})
    if state.decoder is not None:
        state.decoder.load_state_dict({k: torch.from_numpy(arrays["decoder." + k])
                                       for k in state.decoder.state_dict()})
    with torch.no_grad():
        for i, slot in enumerate(state.optimizer.slots):
            for j, t in enumerate(slot):
                t.copy_(torch.from_numpy(arrays[f"opt.{i}.{j}"]))
        state.method_state.running_expectation.copy_(
            torch.from_numpy(arrays["method.running_expectation"]))
    state.optimizer.count = meta["opt_count"]
    state.generator.set_state(torch.from_numpy(arrays["generator"]))
    return meta


# -- training states of the JAX package ----------------------------------------
#
# topaz_tpu/train/trainer.py:192-211 stores jax.tree_util.tree_leaves of its
# TrainState(params, model_state, opt_state, method_state, rng) as leaf_0 ..
# leaf_{n-1}, without names. Dict keys flatten in sorted order ('classifier'
# < 'features' < 'generative', '10' < '2'); optax's adam state is
# (ScaleByAdamState(count, mu, nu), EmptyState()), mu and nu each the params
# tree. The order is rebuilt here from the port's own state, with no JAX.

def is_jax_state(meta: Dict) -> bool:
    """Whether a training state's meta is the JAX package's."""
    return meta.get("format") != STATE_FORMAT and "n_leaves" in meta


def _sorted_leaves(tree) -> List[np.ndarray]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]
    return [np.asarray(tree)]


def _fill(tree, leaves):
    """``tree``'s structure with its leaves taken, in order, from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _fill(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _port_tensors(spec, params: Dict, model_state: Dict) -> List[torch.Tensor]:
    """The picker's (and decoder's) parameters in the optimizer's order for
    a JAX params tree (weights, or an Adam moment of them)."""
    out = list(picker_from_numpy(spec, params, model_state).parameters())
    if "generative" in params:
        out += list(generator_from_numpy(params["generative"]).parameters())
    return out


def _load_jax_state(path: str, arrays: Dict, meta: Dict, state: TrainState) -> None:
    if state.optimizer.kind != "adam":
        raise ValueError(f"{path}: a JAX training state holds Adam's moments; this run's "
                         f"optimizer is {state.optimizer.kind}")
    params, model_state = picker_to_numpy(state.model)
    if state.decoder is not None:
        params["generative"] = generator_to_numpy(state.decoder)
    template = (_sorted_leaves(params) + _sorted_leaves(model_state)
                + [np.zeros((), np.int32)] + 2 * _sorted_leaves(params)
                + [np.zeros((), np.float32), np.zeros(2, np.uint32)])
    if meta["n_leaves"] != len(template):
        raise ValueError(
            f"training state at {path} has {meta['n_leaves']} leaves but the current "
            f"model/optimizer/method configuration expects {len(template)}; resume with "
            f"the same architecture, optimizer, and method flags as the original run")
    leaves = [arrays[f"leaf_{i}"] for i in range(len(template))]
    for i, (arr, want) in enumerate(zip(leaves, template)):
        if arr.shape != want.shape:
            raise ValueError(
                f"training state leaf {i} has shape {arr.shape} but the current "
                f"configuration expects {want.shape} (architecture mismatch)")
    it = iter(leaves)
    params = _fill(params, it)
    model_state = _fill(model_state, it)
    count = int(next(it))
    mu, nu = _fill(params, it), _fill(params, it)
    running_expectation = next(it)

    spec = state.model.spec
    device = state.model.classifier_w.device
    state.model.load_state_dict(picker_from_numpy(spec, params, model_state).state_dict())
    if state.decoder is not None:
        state.decoder.load_state_dict(generator_from_numpy(params["generative"]).state_dict())
    with torch.no_grad():
        for slot, moment in zip(state.optimizer.slots, (mu, nu)):
            for t, v in zip(slot, _port_tensors(spec, moment, model_state)):
                t.copy_(v.to(device))
        state.method_state.running_expectation.copy_(torch.from_numpy(running_expectation))
    state.optimizer.count = count
