"""K1/K2 (the adaptive conv's forward, input and weight gradients) over
the traced window: the sum of each call's bound (``kernel_work``, from the
shapes the entries were called with) over the device time of the kernels
of the family (``kernel_families.json``), in %."""

from portbench.metrics._common import roofline


def read(run):
    return roofline(run, "train", "kconv", ("k1", "k2"))
