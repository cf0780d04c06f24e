"""K1 (the adaptive conv's forward) over a sampling run's traced window:
the sum of each call's bound (``kernel_work``, from the shapes the
entries were called with) over the device time of the kernels of the
family (``kernel_families.json``), in %."""

from portbench.metrics._common import roofline


def read(run):
    return roofline(run, "sample", "kconv", ("k1",))
