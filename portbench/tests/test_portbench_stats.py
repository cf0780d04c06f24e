"""The rate and percentile arithmetic, and the trace's busy and idle
arithmetic, on made-up windows."""

import random

from portbench import harness
from portbench.trace import Summary


def test_quantiles():
    xs = list(range(1, 101))
    assert harness.quantile(xs, 0.5) == 50.5
    assert abs(harness.quantile(xs, 0.95) - 95.05) < 1e-9
    assert harness.quantile([7.0], 0.95) == 7.0


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    rng = random.Random(0)
    steady = [0.020 + 0.001 * rng.random() for _ in range(400)]
    stalled = list(steady)
    for i in range(0, 400, 20):  # one request in 20 waits 50 ms more
        stalled[i] += 0.050
    assert harness.quantile(stalled, 0.95) > harness.quantile(steady, 0.95)
    assert abs(harness.quantile(stalled, 0.5)
               / harness.quantile(steady, 0.5) - 1) < 0.01
    assert harness.rate(len(stalled), sum(stalled)) < harness.rate(
        len(steady), sum(steady))


def test_busy_idle_and_gaps():
    us = 1000
    device = [(10 * us, 20 * us, "k_a<1>(int)", True),
              (15 * us, 30 * us, "k_b(float)", True),
              (100 * us, 110 * us, "Memcpy HtoD", False)]
    host = [(30 * us, 100 * us, "aten::item"),
            (40 * us, 45 * us, "cudaStreamSynchronize")]
    s = Summary((0, 200 * us), device, host)
    assert s.busy_s == 30e-6
    assert abs(s.window_s - 200e-6) < 1e-12
    assert len(s.kernels) == 2
    gaps = dict((k, v) for k, v in s.idle_gaps())
    assert abs(gaps["aten::item"] - 70e-6) < 1e-12
    assert abs(sum(gaps.values()) - 170e-6) < 1e-12
    ops = dict(s.device_ops())
    assert abs(ops["k_b"] - 15e-6) < 1e-12 and "k_a" in ops
