"""The staged upload of ``topaz_tpu_torch.device`` on the CPU.

On a card, large host arrays go through the card's pinned ``StagingRing``;
on the CPU nothing is uploaded, so that route never runs. The fixture
``cpu_staging`` routes numpy arrays bound for the CPU as they would be
routed to a card, through an unpinned ring of ``SLOT`` floats a slot that
casts on three threads, so that the CPU tests run the route's chunking,
casts and counters. It yields the ring."""

import numpy as np
import pytest
import torch

from topaz_tpu_torch import device

SLOT = 100_003  # floats a slot: no test size is a multiple of it
CARD = torch.device("cuda", 0)


@pytest.fixture
def cpu_staging(monkeypatch):
    monkeypatch.setattr(device, "_PART", 4096)  # a chunk's cast split in 3
    ring = device.StagingRing(pinned=False, slots=2, slot_bytes=4 * SLOT, threads=3)
    route = device._route

    def as_on_a_card(x, dev):
        return route(x, CARD) if isinstance(x, np.ndarray) else route(x, dev)

    monkeypatch.setattr(device, "_route", as_on_a_card)
    monkeypatch.setattr(device, "staging_ring", lambda dev: ring)
    yield ring
    ring.close()
