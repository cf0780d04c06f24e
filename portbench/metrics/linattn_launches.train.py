"""The linear-attention kernel's device launches per iteration: three per
linear attention of G's forwards without gradient, the d_step's fakes
(one G forward an iteration: 6 calls × 3 = 18 in ``up-train-b8``); the
g_step differentiates its calls and runs the plain form."""

from portbench.metrics._linattn import linattn_launches


def read(run):
    return linattn_launches(run, "train")
