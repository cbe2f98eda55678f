"""A run with the timed path broken underneath reads ``correct`` false.

Each case skips the harness's look for a card and drives the rest of a
run on the CPU, at a size the CPU holds, with one fault planted in the
program: an answer altered where it is produced (every pick's score moved
by 1e-3 of its size), half of the batch left out of the normalization (its
fit taken over the rest), and a step that returns its input unchanged (the
U-Net). The cells run on one card, so no exchange between cards can be left
out.
"""

import time

import pytest
import torch

import topaz_tpu_torch.pipeline as pipeline
from harness import cell as cells
from tiny import tiny_cell


def _altered_scores(monkeypatch):
    real = pipeline.nms_topk_batched

    def fault(scores, r, t, k):
        vals, coords, counts = real(scores, r, t, k)
        return vals + 1e-3 * torch.clamp(vals.abs(), min=1.0), coords, counts
    monkeypatch.setattr(pipeline, "nms_topk_batched", fault)


def _half_batch_fit(monkeypatch):
    real = pipeline.norm_fit

    def fault(x, w=None, **kw):
        half = max(1, x.shape[0] // 2)
        out = real(x[:half], w=None if w is None else w[:half], **kw)
        return tuple(torch.cat([v, v[:1].expand((x.shape[0] - half,) + v.shape[1:])])
                     for v in out)
    monkeypatch.setattr(pipeline, "norm_fit", fault)


def _unet_returns_input(monkeypatch):
    from topaz_tpu_torch.models.denoise import UDenoiseNet

    monkeypatch.setattr(UDenoiseNet, "forward", lambda self, x: x)


FAULTS = {"altered_answer": _altered_scores, "half_batch": _half_batch_fit,
          "unchanged_step": _unet_returns_input}
CASES = [("session.mixed", None), ("session.mixed", "altered_answer"),
         ("session.mixed", "half_batch"), ("session.mixed", "unchanged_step"),
         ("denoise.full", None), ("denoise.full", "unchanged_step")]


@pytest.mark.parametrize("name, fault", CASES)
def test_bm_fault_reads_incorrect(monkeypatch, name, fault):
    if fault:
        FAULTS[fault](monkeypatch)
    result, compared = cells.run_cell(tiny_cell(name), 2**31 + 101, 1.0, False,
                                      time.perf_counter(), device="cpu")
    assert result["correct"] is (fault is None), compared
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == {"setup_s", {"session.mixed": "picked_micrographs_per_s",
                                                  "denoise.full": "denoised_mpix_per_s"}[name]}
