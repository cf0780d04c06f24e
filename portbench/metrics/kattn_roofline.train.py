"""K3/K4/K5 (the fused attention's forward, backward and the backward's
adjoint in R1's double backward) over the traced window: the sum of each
call's bound over the device time of the family's kernels, in %."""

from portbench.metrics._common import roofline


def read(run):
    return roofline(run, "train", "kattn", ("k3", "k4", "k5"))
