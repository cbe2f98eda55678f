"""Device milliseconds of a micrograph's greedy NMS, a micrograph: the
kernels launched inside the program's ``extract/nms`` spans (the rounds
over the score map, three disk max-filters a round)."""


def read(run):
    if run.trace is None or run.driver.completed == 0:
        return None
    s = run.trace["device_s_by_span"].get("extract/nms")
    return None if not s else 1e3 * s / run.driver.completed
