"""Host milliseconds the pipeline's dispatching thread waits on the
loaders' queue, a micrograph: the program's ``pipeline/wait`` spans (each
``next()`` on the prefetch queue in ``MicrographPipeline.process``) that
ended at or after the earliest start among the window's reads (the
``pipeline/read`` span's newest ``completed`` samples), summed, over the
micrographs answered. None where the program keeps no such record or a
ring has lost part of the window."""


def _window_reads(run):
    from topaz_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    n = run.driver.completed
    if records is None or n == 0:
        return None
    reads = records("pipeline/read")
    return reads[-n:] if len(reads) >= n else None


def read(run):
    from topaz_tpu_torch.utils import profiling

    reads = _window_reads(run)
    if reads is None:
        return None
    t0 = min(s.start_ns for s in reads)
    waits = profiling.records("pipeline/wait")
    lost = profiling.count("pipeline/wait") > len(waits)
    if not waits or (lost and waits[0].end_ns >= t0):
        return None
    return sum(s.end_ns - s.start_ns for s in waits if s.end_ns >= t0) / 1e6 / len(reads)
