"""Device milliseconds of the picker's forward (models/picker.py), a
micrograph: the kernels launched inside the benchmark's bm/picker spans."""

from harness.measure import span_ms_per_answer


def read(run):
    return span_ms_per_answer(run, "picker")
