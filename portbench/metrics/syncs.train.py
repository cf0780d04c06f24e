"""The calls per iteration at which the host waits for the card (the
``gigagan.sync.*`` spans: pageable host-to-device copies and readbacks)
in the traced window; the log step's sync, on the operator's cadence, is
not among them."""

from portbench.metrics._spans import syncs_per_unit


def read(run):
    return syncs_per_unit(run, "train")
