"""Device kernel launches per iteration (all kernels: the port's, cuDNN's,
cuBLAS's and aten's), counted from the profiler's kernel events over the
traced window."""

from portbench.metrics._common import launches


def read(run):
    return launches(run, "train")
