"""The demodulation kernel's device launches per request (two per
demodulated conv of G's forward: the scale, then its splits' sum)."""

from portbench.metrics._demod import demod_launches


def read(run):
    return demod_launches(run, "sample")
