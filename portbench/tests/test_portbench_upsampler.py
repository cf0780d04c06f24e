"""The upsampler's cell resolves by name to its configuration, traffic,
driver, limits and readers; and the comparison that decides ``correct``
fails what it must on the upsampler's driver (whole runs on the CPU at a
tiny size of its shapes, held to ``up-train-b8``'s limits): a sound run
passes, a planted fault fails, a fault in G's backward fails on its
layer's number (``layer_check.py``), the control (the reference in fp8
in the program's place) fails.  The driver's copy of the train
driver runs with its substitutes."""

import pytest

from portbench import faults, faults_backward, harness
from portbench.drivers import train_upsampler
from portbench.tests import tiny
from portbench.tests.tiny_upsampler import LINEAR_ATTENTIONS, train_cell

NEW = {"up-train-b8": ("upsampler-256", "train_upsampler")}


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_cells_resolve(name):
    cell = harness.resolve(name)
    config, driver = NEW[name]
    assert cell.chips == 1
    assert cell.traffic["driver"] == driver and cell.traffic["batch"] == 8
    assert cell.traffic["first_step"] == 4
    assert cell.traffic["reference_rows"] == 2
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert [m["name"] for m in cell.end_to_end] == [
        "train_img_per_s", "peak_mem_gib", "setup_s"]
    layer = {m["name"] for m in cell.per_layer}
    assert {"launches.train", "mfu.train", "kconv_roofline.train",
            "kattn_roofline.train", "device_idle.train", "data_idle.train",
            "data_wait.train", "syncs.train", "step_idle.train"} <= layer
    up = {"up_g_share.train", "linattn_share.train",
          "linattn_roofline.train"}
    assert layer & up == (up if name == "up-train-b8" else set())
    generator = cell.config["generator"]
    if config == "upsampler-256":
        assert cell.config["trainer"] == {"train_upsampler": True}
        assert generator["input_image_size"] == 64
        assert cell.config["discriminator"][
            "multiscale_input_resolutions"] == [128]
    assert harness.driver(cell).run


def limits():
    return harness.resolve("up-train-b8").limits


def run(tmp, plant=None):
    return train_upsampler.run(tiny.context(train_cell(limits()), tmp,
                                            plant=plant))


def test_sound_run_passes(tmp_path):
    outcome = run(tmp_path)
    assert outcome.correct, outcome.compared
    assert outcome.kind == "train" and outcome.metrics["train_img_per_s"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half-batch"])
def test_planted_fault_fails(fault, tmp_path):
    outcome = run(tmp_path, faults.FAULTS[fault])
    assert not outcome.correct, outcome.compared


@pytest.mark.parametrize("fault,number", [("k2-dw", "aconv_gap"),
                                          ("linattn-dq", "linattn_gap")])
def test_fault_in_g_backward_fails_on_its_layer(fault, number, tmp_path):
    try:
        outcome = run(tmp_path, faults_backward.FAULTS[fault])
    finally:
        faults_backward.restore()
    value, limit = outcome.compared[number]
    assert value > limit and not outcome.correct, outcome.compared


def test_the_copy_runs_with_its_substitutes(tmp_path):
    """A traced run of the driver's copy of the train driver: its window
    is the attributing one (the linear attention's calls counted on its
    summary), and its comparison holds the layer check's numbers."""
    outcome = train_upsampler.run(tiny.context(
        train_cell(limits()), tmp_path, trace=True))
    assert outcome.correct, outcome.compared
    # one traced cadence: four G steps and four D steps' fakes
    assert outcome.trace.linattn_calls == 8 * LINEAR_ATTENTIONS
    assert outcome.trace.linattn_bound_s > 0
    assert isinstance(outcome.trace.span_device_s, dict)
    assert {"aconv_gap", "linattn_gap"} <= set(outcome.compared)


def test_control_fails(tmp_path):
    numbers = train_upsampler.control(tiny.context(train_cell(limits()),
                                                   tmp_path))
    assert any(v > lim for v, lim in numbers.values()), numbers


def test_the_base_train_driver_is_not_touched():
    from portbench.drivers import train
    from portbench.reference import trainer
    from portbench.trace import Traced

    assert train_upsampler.run is not train.run
    assert train.ref_trainer is trainer and train.Traced is Traced
    assert train.program_check.__module__ == train.__name__
    assert train.reference_check.__module__ == train.__name__
