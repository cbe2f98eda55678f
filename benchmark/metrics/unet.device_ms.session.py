"""Device milliseconds of the U-Net's forward (models/denoise.py), a
micrograph: the kernels launched inside the benchmark's bm/unet spans."""

from harness.measure import span_ms_per_answer


def read(run):
    return span_ms_per_answer(run, "unet")
