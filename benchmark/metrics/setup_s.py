"""Seconds from process start until the window opens: inputs, models,
kernel builds on a checkout's first run, and the warm-up of every shape."""


def read(run):
    return run.setup_s
