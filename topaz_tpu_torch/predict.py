"""Micro-batched scoring helpers (port of topaz_tpu/predict.py, the
reference's topaz/predict.py:7-35).

The signature differs from the JAX package's: where ``score_stream(spec,
params, state, images, ...)`` jits ``apply_picker`` over a parameter tree,
the port takes the picker as an ``nn.Module`` (``models.factory.load_picker``
or ``init_picker``) and the device to score on, and has no ``precision``
(the port scores in float32 with TF32 off).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List

import numpy as np
import torch

from topaz_tpu_torch.device import resolve_device


def batches(X: Iterable[np.ndarray], batch_size: int = 1) -> Iterator[np.ndarray]:
    """Group a stream of same-shaped arrays into stacked float32 batches."""
    batch = []
    for x in X:
        batch.append(np.asarray(x, dtype=np.float32))
        if len(batch) >= batch_size:
            yield np.stack(batch, 0)
            batch = []
    if batch:
        yield np.stack(batch, 0)


def score_stream(model: torch.nn.Module, images: Iterable[np.ndarray], batch_size: int = 1,
                 dense: bool = True, device="cuda") -> Iterator[np.ndarray]:
    """Stream score maps (logits) for same-shaped images, ``batch_size`` a
    forward on ``device``; the module is moved there (in place, as
    ``nn.Module.to`` does). Yields one float32 numpy array an image."""
    dev = resolve_device(device)
    model = model.to(dev)
    for batch in batches(images, batch_size=batch_size):
        with torch.inference_mode():
            logits = model(torch.from_numpy(batch).to(dev), dense=dense)
        yield from logits.float().cpu().numpy()


def score(model: torch.nn.Module, images: Iterable[np.ndarray], batch_size: int = 1,
          dense: bool = True, device="cuda") -> List[np.ndarray]:
    """``score_stream`` as a list."""
    return list(score_stream(model, images, batch_size=batch_size, dense=dense,
                             device=device))
