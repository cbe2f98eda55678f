"""Micrographs whose picks (and denoised image) were answered in the
window, over the window's seconds (whole passes, host clock)."""


def read(run):
    return run.driver.completed / run.window_s
