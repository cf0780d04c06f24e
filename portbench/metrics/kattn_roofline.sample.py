"""K3 (the fused attention's forward) over a sampling run's traced
window: the sum of each call's bound over the device time of the
family's kernels, in %."""

from portbench.metrics._common import roofline


def read(run):
    return roofline(run, "sample", "kattn", ("k3",))
