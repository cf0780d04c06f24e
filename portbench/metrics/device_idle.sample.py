"""The share of the traced window in which no kernel, copy or fill ran on
the card (the union of the profiler's device intervals), in %."""

from portbench.metrics._common import idle


def read(run):
    return idle(run, "sample")
