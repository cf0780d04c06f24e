"""The reader of ``graph_share.sample`` (the share of a traced window's
requests whose G forward was a replay of a captured CUDA graph) on
hand-built traced windows: replays over requests, None for a window
without a request span and for a program that declares no replay span,
and its name against BENCHMARK.json and the files under ``metrics/``."""

import json

import pytest

from portbench import harness, trace
from portbench.metrics import _spans

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
METRIC = "graph_share.sample"
BUSY = [(1000, 3000), (6000, 9000)]
# three requests: the first ran G eagerly, the second captured and
# replayed, the third replayed; the fourth starts in the window
HOST = [(0, 2000, "gigagan.sample.request"),
        (100, 1800, "gigagan.sample.generator"),
        (2000, 5000, "gigagan.sample.request"),
        (2100, 4000, "gigagan.sample.graph_capture"),
        (4000, 4500, "gigagan.sample.graph_replay"),
        (5000, 7000, "gigagan.sample.request"),
        (5100, 5200, "gigagan.sample.graph_replay"),
        (9000, 12_000, "gigagan.sample.request"),
        (9100, 9200, "gigagan.sample.graph_replay")]


def run_of(kind, host, device=BUSY, units=4, window=(0, 10_000)):
    """An Outcome whose traced window spans ``window`` (ns), with the
    device intervals ``device`` and the host events ``host``."""
    s0, s1 = window
    device = [(max(s, s0), min(e, s1), "kernel", True) for s, e in device]
    return harness.Outcome(correct=True, attempted=1, failed=0, metrics={},
                           compared={}, device_peak_bytes=0, kind=kind,
                           units=units, trace=trace.Summary(window, device,
                                                            host))


def read(run):
    return harness.reader(METRIC).read(run)


def test_counts_replays_over_requests():
    assert read(run_of("sample", HOST)) == pytest.approx(75.0)
    eager = [x for x in HOST if "graph" not in x[2]]
    assert read(run_of("sample", eager)) == 0.0
    every = [x for x in HOST if x[2] != "gigagan.sample.generator"] + [
        (200, 300, "gigagan.sample.graph_replay")]
    assert read(run_of("sample", every)) == pytest.approx(100.0)


def test_spans_outside_the_window_do_not_count():
    late = HOST + [(10_500, 11_000, "gigagan.sample.request"),
                   (10_600, 10_700, "gigagan.sample.graph_replay")]
    assert read(run_of("sample", late)) == pytest.approx(75.0)


@pytest.mark.parametrize("case", ["train_run", "no_request", "outside",
                                  "untraced", "no_units", "no_replay_span"])
def test_none(case, monkeypatch):
    """A train run, a window without a request span, a run without a trace
    or without units, and a program that declares no replay span (the
    parent, which has no graph): None, not 0."""
    if case == "train_run":
        run = run_of("train", HOST)
    elif case == "no_request":
        run = run_of("sample", [(0, 9000, "gigagan.train.iteration"),
                                (100, 200, "gigagan.sample.graph_replay")])
    elif case == "outside":
        run = run_of("sample", [(-900, -100, _spans.UNIT["sample"])])
    elif case == "untraced":
        run = run_of("sample", HOST)
        run.trace = None
    elif case == "no_units":
        run = run_of("sample", HOST, units=0)
    else:
        from gigagan_tpu_torch.utils import profiling
        monkeypatch.setattr(profiling, "SPANS", tuple(
            n for n in profiling.SPANS if "graph" not in n))
        run = run_of("sample", [x for x in HOST if "graph" not in x[2]])
    assert read(run) is None


def test_name_matches_the_benchmark_and_the_files():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    files = {p.stem for p in (harness.PACKAGE / "metrics").glob("*.py")
             if not p.stem.startswith("_")}
    assert METRIC in entries and METRIC in files
    entry = entries[METRIC]
    cells = {w["name"]: w["traffic"] for w in BENCH["workloads"]}
    assert entry["workloads"] == ["qs-sample-b1"]
    assert all(cells[w].startswith("sample") for w in entry["workloads"])
    assert entry["layer"] in {m["layer"] for m in BENCH["per_layer"]
                              if m["name"] != METRIC}
    assert entry["moves"] == "sample_ms_p50"
    assert BENCH["per_layer"][-1]["name"] == METRIC
    assert callable(harness.reader(METRIC).read)
