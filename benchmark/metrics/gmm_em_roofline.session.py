"""The EM kernel's (csrc/gmm_em.cu) share of its bound, in percent: the
least time the card's MUFU pipe takes for the posterior evaluations of the
micrographs answered (each image's valid pixels times, a lane, one plus the
steps the reference's own fit of that file took), over the kernel's time in
the trace."""

from harness.measure import kernel_s
from reference import counts


def read(run):
    t = kernel_s(run, "gmm_em")
    if t <= 0:
        return None
    evals = sum(run.facts["em_evaluations"][path] for path, *_ in run.driver.answers)
    return 100.0 * counts.em_bound_s(evals) / t
