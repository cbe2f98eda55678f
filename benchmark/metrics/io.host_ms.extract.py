"""Mean host milliseconds of a micrograph's file work on the per-micrograph
route: the program's ``extract/read`` span (the MRC file loaded and
copied) plus its ``extract/write`` span (its picks' lines written), over
the window's micrographs. Passes run one after another, so the window's
are each span's newest ``completed`` samples; None where the program keeps
no such record or its ring has lost part of the window."""

SPANS = ("extract/read", "extract/write")


def read(run):
    from topaz_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    n = run.driver.completed
    if records is None or n == 0:
        return None
    total_ns = 0
    for name in SPANS:
        spans = records(name)
        if len(spans) < n:
            return None
        total_ns += sum(s.end_ns - s.start_ns for s in spans[-n:])
    return total_ns / 1e6 / n
