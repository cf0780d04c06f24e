"""The readers of the program's phase spans (``metrics/_spans.py`` and the
six metrics on it) on hand-built traced windows: the card's idle time
inside spans (nested, overlapping and cut by the window's edges, each idle
instant once), the per-unit division, None for a window without an
iteration or request span, and the names against BENCHMARK.json and the
files under ``metrics/``."""

import json

import pytest

from portbench import harness, trace
from portbench.metrics import _spans

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = {
    "data_idle.train": "train", "data_wait.train": "train",
    "syncs.train": "train", "step_idle.train": "train",
    "step_idle.sample": "sample", "syncs.sample": "sample",
}


def run_of(kind, host, device, units, window=(0, 10_000)):
    """An Outcome whose traced window spans ``window`` (ns), with the
    device intervals ``device`` ((start, end)) and the host events
    ``host`` ((start, end, name), unclipped as ``trace.summarize`` keeps
    them)."""
    s0, s1 = window
    device = [(max(s, s0), min(e, s1), "kernel", True) for s, e in device]
    summary = trace.Summary(window, device, host)
    return harness.Outcome(correct=True, attempted=1, failed=0, metrics={},
                           compared={}, device_peak_bytes=0, kind=kind,
                           units=units, trace=summary)


def read(metric, run):
    return harness.reader(metric).read(run)


# the card busy over [1000, 3000] and [6000, 9000] of a 10 µs window: idle
# [0, 1000], [3000, 6000], [9000, 10000]
BUSY = [(1000, 3000), (6000, 9000)]
TRAIN = [
    (0, 5000, "gigagan.train.iteration"),
    (5000, 10_000, "gigagan.train.iteration"),
    (0, 1500, "gigagan.train.batch"),           # idle 1000
    (100, 600, "gigagan.train.data_wait"),
    (200, 300, "gigagan.sync.batch_to_device"),
    (1500, 4000, "gigagan.train.d_step"),       # idle 3000-4000
    (2000, 3800, "gigagan.d.loss"),             # nested: not read
    (3500, 5000, "gigagan.train.g_step"),       # overlaps d_step: 4000-5000
    (5000, 6500, "gigagan.train.batch"),        # idle 1000
    (5100, 5300, "gigagan.train.data_wait"),
    (5400, 5450, "gigagan.sync.blur_kernel"),
    (6500, 10_000, "gigagan.train.g_step"),     # idle 1000
    (6600, 6700, "gigagan.sync.blur_kernel"),
    (3000, 6000, "aten::to"),                   # not a span
]


def test_train_readers():
    run = run_of("train", TRAIN, BUSY, units=2)
    assert read("data_idle.train", run) == pytest.approx(20.0)
    assert read("step_idle.train", run) == pytest.approx(30.0)
    assert read("data_wait.train", run) == pytest.approx(700 / 1e6 / 2)
    assert read("syncs.train", run) == pytest.approx(1.5)
    # the sample readers find nothing in a train run
    assert read("step_idle.sample", run) is None
    assert read("syncs.sample", run) is None


def test_units_divide_counts_and_times():
    one = run_of("train", TRAIN, BUSY, units=1)
    four = run_of("train", TRAIN, BUSY, units=4)
    assert read("syncs.train", one) == 4 * read("syncs.train", four) == 3
    assert read("data_wait.train", one) == pytest.approx(
        4 * read("data_wait.train", four))
    # shares of the window do not depend on the units
    assert read("data_idle.train", one) == read("data_idle.train", four)


def test_idle_is_counted_once_under_nested_and_repeated_spans():
    host = [(0, 10_000, "gigagan.train.iteration"),
            (0, 4000, "gigagan.train.batch"),
            (500, 3500, "gigagan.train.batch"),
            (200, 3800, "gigagan.train.batch")]
    run = run_of("train", host, BUSY, units=1)
    # idle inside [0, 4000]: [0, 1000] and [3000, 4000]
    assert read("data_idle.train", run) == pytest.approx(20.0)
    assert _spans.union([(5, 9), (0, 2), (1, 3), (9, 10)]) == [[0, 3],
                                                               [5, 10]]
    assert _spans.overlap_ns([[0, 3], [5, 10]], [(2, 6), (8, 20)]) == 4


def test_spans_are_clipped_to_the_window():
    host = [(-5000, 4000, "gigagan.train.iteration"),
            (-5000, 500, "gigagan.train.batch"),        # idle 0-500 inside
            (-3000, -1000, "gigagan.train.data_wait"),  # outside: dropped
            (-3000, -2000, "gigagan.sync.batch_to_device"),
            (9500, 12_000, "gigagan.train.d_step"),     # idle 9500-10000
            (9900, 11_000, "gigagan.train.data_wait")]  # 100 ns inside
    run = run_of("train", host, BUSY, units=1)
    assert read("data_idle.train", run) == pytest.approx(5.0)
    assert read("step_idle.train", run) == pytest.approx(5.0)
    assert read("data_wait.train", run) == pytest.approx(100 / 1e6)
    assert read("syncs.train", run) == 0


def test_sample_readers():
    # idle inside G: 500-1000 and 3000-3500, then 5200-6000 and 9000-9200
    host = [(0, 4000, "gigagan.sample.request"),
            (500, 3500, "gigagan.sample.generator"),
            (3500, 3900, "gigagan.sync.readback"),
            (5000, 9500, "gigagan.sample.request"),
            (5200, 9200, "gigagan.sample.generator"),
            (9200, 9400, "gigagan.sync.readback")]
    run = run_of("sample", host, BUSY, units=2)
    assert read("step_idle.sample", run) == pytest.approx(20.0)
    assert read("syncs.sample", run) == pytest.approx(1.0)
    assert read("step_idle.train", run) is None


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_none_without_a_unit_span(metric):
    """A program without spans, a window without an iteration or request
    span, a run without a trace or without units: None, not 0."""
    kind = SPAN_METRICS[metric]
    parent = run_of(kind, [(0, 9000, "aten::to")], BUSY, units=2)
    assert read(metric, parent) is None
    other = "gigagan.sample.request" if kind == "train" else \
        "gigagan.train.iteration"
    wrong = run_of(kind, [(0, 9000, other), (100, 200, "gigagan.sync.x")],
                   BUSY, units=2)
    assert read(metric, wrong) is None
    outside = run_of(kind, [(-900, -100, _spans.UNIT[kind])], BUSY, units=2)
    assert read(metric, outside) is None
    untraced = run_of(kind, [], BUSY, units=2)
    untraced.trace = None
    assert read(metric, untraced) is None
    empty = run_of(kind, [(0, 9000, _spans.UNIT[kind])], BUSY, units=0)
    assert read(metric, empty) is None


def test_names_match_the_benchmark_and_the_files():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    files = {p.stem for p in (harness.PACKAGE / "metrics").glob("*.py")
             if not p.stem.startswith("_")}
    cells = {w["name"]: w["traffic"] for w in BENCH["workloads"]}
    for name, kind in SPAN_METRICS.items():
        assert name in entries and name in files
        entry = entries[name]
        assert entry["workloads"], name
        assert all(cells[w].startswith(kind) for w in entry["workloads"])
        assert entry["layer"] in {m["layer"] for m in BENCH["per_layer"]
                                  if m["name"] not in SPAN_METRICS}
        assert callable(harness.reader(name).read)
    # the six are the last entries, appended after the accepted ones
    assert [m["name"] for m in BENCH["per_layer"][-6:]] == list(SPAN_METRICS)
