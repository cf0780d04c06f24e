"""The operations the configuration requires per image, times the images
per second of the untraced window, over one H100's dense bf16 peak (989 TFLOP/s), in %.  The count
is the reference's matrix products and convolutions
(``portbench/flops.py``)."""

from portbench.metrics._common import mfu


def read(run):
    return mfu(run, "train")
