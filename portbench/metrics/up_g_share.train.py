"""The device time of the kernels of the UNet upsampler's forward (the
``gigagan.up.generator`` spans) and of its backward, over the card's busy
time in the traced window, in %: the UNet's share of a training step."""

from portbench.metrics._attributed import busy_share


def read(run):
    return busy_share(run, "gigagan.up.generator")
