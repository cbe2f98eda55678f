"""Device milliseconds of the download of each denoised micrograph, a
micrograph: the copies launched inside the program's ``denoise/fetch``
spans (``denoise_image``: the output back to host memory)."""


def read(run):
    if run.trace is None or run.driver.completed == 0:
        return None
    s = run.trace["device_s_by_span"].get("denoise/fetch")
    return None if not s else 1e3 * s / run.driver.completed
