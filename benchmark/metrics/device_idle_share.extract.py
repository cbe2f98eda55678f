"""Share of the traced window in which no kernel, copy or memset ran."""

from harness.measure import idle_share


def read(run):
    return idle_share(run)
