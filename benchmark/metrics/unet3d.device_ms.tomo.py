"""Device milliseconds of the 3D U-Net's forwards, a tomogram: the kernels
launched inside the program's ``denoise3d/unet`` spans (``Denoise3D``: a
patch's or batch's own normalisation, the network, its scale restored)."""


def read(run):
    if run.trace is None or run.driver.completed == 0:
        return None
    s = run.trace["device_s_by_span"].get("denoise3d/unet")
    return None if not s else 1e3 * s / run.driver.completed
