"""The card's idle time while the trainer collects its batches (the
``gigagan.train.batch`` spans: the wait on the loader, the stacking and,
text-conditioned, CLIP's text embedding), as a share of the traced
window, in %."""

from portbench.metrics._spans import idle_inside


def read(run):
    return idle_inside(run, "train", {"gigagan.train.batch"})
