"""Device milliseconds of the upload of each micrograph, a micrograph: the
copies (and kernels) launched inside the program's ``denoise/upload`` spans
(``denoise_image``: the micrograph to the card as float32)."""


def read(run):
    if run.trace is None or run.driver.completed == 0:
        return None
    s = run.trace["device_s_by_span"].get("denoise/upload")
    return None if not s else 1e3 * s / run.driver.completed
