"""Device milliseconds of a tomogram's transfers, a tomogram: the copies
and kernels launched inside the program's ``denoise3d/upload`` (the volume
to the card, its statistics and zero-padded copy) and ``denoise3d/fetch``
(the output back to host memory) spans."""


def read(run):
    if run.trace is None or run.driver.completed == 0:
        return None
    spans = run.trace["device_s_by_span"]
    s = spans.get("denoise3d/upload", 0.0) + spans.get("denoise3d/fetch", 0.0)
    return None if not s else 1e3 * s / run.driver.completed
