"""The trainer's wait on the loader's queue (the ``gigagan.train.data_wait``
spans around each ``next`` of the loader), summed per iteration of the
traced window, in ms."""

from portbench.metrics._spans import ms_per_unit


def read(run):
    return ms_per_unit(run, "train", "gigagan.train.data_wait")
