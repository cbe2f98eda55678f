"""Output pixels denoised in the window, in millions, over its seconds."""


def read(run):
    return run.driver.pixels / 1e6 / run.window_s
