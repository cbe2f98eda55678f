"""Device milliseconds of the uploads of the pipeline's inputs, a
micrograph: the copies (and kernels) launched inside the program's
``pipeline/upload`` spans (``MicrographPipeline.process``: each raw image,
or each host-prepped batch, to the card)."""


def read(run):
    if run.trace is None or run.driver.completed == 0:
        return None
    s = run.trace["device_s_by_span"].get("pipeline/upload")
    return None if not s else 1e3 * s / run.driver.completed
