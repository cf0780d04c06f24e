"""The linear-attention kernel's device launches per request: three per
linear attention of G's forward, which needs no gradient (6 calls × 3 = 18
in ``up-request-1024``)."""

from portbench.metrics._linattn import linattn_launches


def read(run):
    return linattn_launches(run, "sample")
