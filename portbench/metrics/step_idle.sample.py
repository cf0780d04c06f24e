"""The card's idle time inside G's forward of each request (the
``gigagan.sample.generator`` spans): the host issuing G slower than the
card runs it, as a share of the traced window, in %."""

from portbench.metrics._spans import idle_inside


def read(run):
    return idle_inside(run, "sample", {"gigagan.sample.generator"})
