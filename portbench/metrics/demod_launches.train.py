"""The demodulation kernel's device launches per iteration (two per
demodulated conv of G's forwards without gradient: the d_step's fakes)."""

from portbench.metrics._demod import demod_launches


def read(run):
    return demod_launches(run, "train")
