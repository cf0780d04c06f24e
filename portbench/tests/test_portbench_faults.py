"""The comparison that decides ``correct`` fails what it must: whole runs
of each driver (the look for a card skipped, the port on its kernels'
plain versions, tiny shapes) with a fault planted under the timed path,
and the control (the reference in fp8 in the program's place), all held
to the real cells' limits; and the same runs without a fault pass."""

import pytest

from portbench import faults, harness
from portbench.drivers import sample, train
from portbench.tests import tiny

TRAIN = {"qs": (tiny.QS, "qs-train-b32"), "t2i": (tiny.T2I, "t2i-train-b8")}
# the sample cell's limits also for the text-conditioned sampler, which no
# cell runs yet (PERF.md, Open questions)
SAMPLE = {"qs": (tiny.QS, "qs-sample-b1"), "t2i": (tiny.T2I,
                                                   "qs-sample-b1")}


def limits(cell: str) -> dict:
    return harness.resolve(cell).limits


def train_run(tmp, which, plant=None):
    config, cell = TRAIN[which]
    ctx = tiny.context(tiny.train_cell(config, limits(cell)), tmp,
                       plant=plant)
    return train.run(ctx)


def sample_run(tmp, which, plant=None):
    config, cell = SAMPLE[which]
    ctx = tiny.context(tiny.sample_cell(config, limits(cell)), tmp,
                       plant=plant)
    return sample.run(ctx)


@pytest.mark.parametrize("which", ["qs", "t2i"])
def test_sound_runs_pass(which, tmp_path):
    assert train_run(tmp_path, which).correct
    assert sample_run(tmp_path, which).correct


@pytest.mark.parametrize("fault", ["unchanged", "half-batch"])
@pytest.mark.parametrize("which", ["qs", "t2i"])
def test_train_faults_fail(which, fault, tmp_path):
    outcome = train_run(tmp_path, which, faults.FAULTS[fault])
    assert not outcome.correct, outcome.compared


@pytest.mark.parametrize("which", ["qs", "t2i"])
def test_altered_answer_fails(which, tmp_path):
    outcome = sample_run(tmp_path, which, faults.altered)
    assert not outcome.correct, outcome.compared


@pytest.mark.parametrize("which", ["qs", "t2i"])
def test_control_fails(which, tmp_path):
    config, cell = TRAIN[which]
    numbers = train.control(tiny.context(
        tiny.train_cell(config, limits(cell)), tmp_path))
    assert any(v > lim for v, lim in numbers.values()), numbers
    config, cell = SAMPLE[which]
    numbers = sample.control(tiny.context(
        tiny.sample_cell(config, limits(cell)), tmp_path))
    assert any(v > lim for v, lim in numbers.values()), numbers
