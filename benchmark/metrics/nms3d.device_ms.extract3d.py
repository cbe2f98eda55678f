"""Device milliseconds of a tomogram's sphere NMS, a tomogram: the kernels
launched inside the program's ``extract3d/nms`` spans (the greedy rounds
over the score map, three sphere max-filters a round)."""


def read(run):
    if run.trace is None or run.driver.completed == 0:
        return None
    s = run.trace["device_s_by_span"].get("extract3d/nms")
    return None if not s else 1e3 * s / run.driver.completed
