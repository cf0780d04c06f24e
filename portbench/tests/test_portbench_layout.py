"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, driver, limit file and per-layer metric resolves by name; a
new metric is added by adding a file and an entry, with no existing file
edited."""

import json
import re
import shutil
import sys

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = harness.resolve(cell)
    assert c.chips == 1
    assert harness.driver(c).run
    assert c.limits and all(v > 0 for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in c.per_layer]
    assert layer, "every cell reports a per-layer metric"
    assert all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert callable(harness.reader(m["name"]).read)


def test_names_units_and_files():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        assert c["reduced"] == []
    for w in BENCH["workloads"]:
        assert (harness.PACKAGE / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (harness.ROOT / "PERF.md").read_text()
    assert all(layer in perf for layer in layers)


def test_a_metric_is_added_by_a_file_and_an_entry(tmp_path):
    """In a copy: a dummy metric file and its BENCHMARK.json entry; the
    copied harness finds and reads it, and nothing else changed."""
    shutil.copytree(harness.PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = dict(BENCH)
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "dummy.train", "unit": "%", "better": "higher",
         "source": "program_counter", "layer": "device",
         "moves": "train_img_per_s", "workloads": ["qs-train-b32"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "metrics" / "dummy.train.py").write_text(
        "def read(run):\n    return 42.0 if run.kind == 'train' else None\n")
    copied = harness.load_module(tmp_path / "portbench" / "harness.py",
                                 "portbench_copied_harness")
    try:
        cell = copied.resolve("qs-train-b32", tmp_path / "BENCHMARK.json")
        assert "dummy.train" in [m["name"] for m in cell.per_layer]
        outcome = copied.Outcome(
            correct=True, attempted=1, failed=0, metrics={}, compared={},
            device_peak_bytes=0, kind="train")
        got = copied.metrics_of(cell, outcome, trace=True)
        assert got == {"dummy.train": {"value": 42.0, "unit": "%"}}
    finally:
        sys.modules.pop("portbench_copied_harness", None)
