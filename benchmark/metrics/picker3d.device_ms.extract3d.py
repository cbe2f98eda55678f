"""Device milliseconds of the 3D picker's forwards, a tomogram: the kernels
launched inside the program's ``extract3d/score`` spans (a batch of tiles
through the picker, its scores written into the tomogram's map)."""


def read(run):
    if run.trace is None or run.driver.completed == 0:
        return None
    s = run.trace["device_s_by_span"].get("extract3d/score")
    return None if not s else 1e3 * s / run.driver.completed
