"""The card's idle time inside the D and G updates (the
``gigagan.train.d_step`` and ``gigagan.train.g_step`` spans): the host
issuing the model step slower than the card runs it, as a share of the
traced window, in %."""

from portbench.metrics._spans import idle_inside


def read(run):
    return idle_inside(run, "train",
                       {"gigagan.train.d_step", "gigagan.train.g_step"})
