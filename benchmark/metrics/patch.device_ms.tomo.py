"""Device milliseconds of the resident route's patch loop outside the
network, a tomogram: the kernels launched inside the program's
``denoise3d/patch`` spans (a patch cut from the padded volume, normalised
by the volume's statistics, its centre written back) less those of the
``denoise3d/unet`` forwards nested in them."""


def read(run):
    if run.trace is None or run.driver.completed == 0:
        return None
    spans = run.trace["device_s_by_span"]
    s = spans.get("denoise3d/patch")
    return None if not s else 1e3 * (s - spans.get("denoise3d/unet", 0.0)) / run.driver.completed
