"""Mean host milliseconds of a loader thread's read of one micrograph
(the program's ``pipeline/read`` span in ``MicrographPipeline._load_one``:
the file, its writable copy, the host downsample where on), over the
window's micrographs. Passes run one after another, so the window's reads
are the span's newest ``completed`` samples; None where the program keeps
no such record or its ring has lost part of the window."""


def _window_reads(run):
    from topaz_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    n = run.driver.completed
    if records is None or n == 0:
        return None
    reads = records("pipeline/read")
    return reads[-n:] if len(reads) >= n else None


def read(run):
    reads = _window_reads(run)
    if reads is None:
        return None
    return sum(s.end_ns - s.start_ns for s in reads) / 1e6 / len(reads)
