"""The calls per request at which the host waits for the card (the
``gigagan.sync.*`` spans: the readback of the images, pageable
host-to-device copies) in the traced window."""

from portbench.metrics._spans import syncs_per_unit


def read(run):
    return syncs_per_unit(run, "sample")
