"""Device milliseconds of the picker's whole-image forward, a micrograph:
the kernels launched inside the program's ``extract/score`` spans."""


def read(run):
    if run.trace is None or run.driver.completed == 0:
        return None
    s = run.trace["device_s_by_span"].get("extract/score")
    return None if not s else 1e3 * s / run.driver.completed
