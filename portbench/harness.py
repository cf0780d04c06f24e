"""The benchmark's harness: finds a cell's configuration, traffic, driver,
limits and per-layer metric readers by the names in BENCHMARK.json, runs
the driver on the card, reads the trace, and prints the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

- ``configs/<config>.json``: the configuration (as BENCHMARK.json names
  its file);
- ``traffic/<traffic>.json``: the mix's parameters, with ``driver`` naming
  ``drivers/<driver>.py``, whose ``run(ctx)`` returns an ``Outcome``;
- ``limits/<cell>.json``: each compared number's limit;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)`` →
  a number, or None where the run holds nothing to read."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
OUT = PACKAGE / "out"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gigagan_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Outcome:
    """What a driver's run gives the harness."""

    correct: bool
    attempted: int
    failed: int
    metrics: dict            # end-to-end name → value
    compared: dict           # number → (value, limit)
    device_peak_bytes: int
    kind: str                # "train" or "sample": the per-layer split
    units: float = 0.0       # iterations or requests in the traced window
    flops_per_unit: Optional[float] = None
    rate_units_per_s: Optional[float] = None  # the untraced window's
    trace: Optional[object] = None            # trace.Summary
    calls: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)


def load_module(path: Path, name: str):
    """The module in ``path``, imported under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of the benchmark at ``bench_path``, its files read
    from the folder that holds this module (beside that file's root)."""
    bench = json.loads(bench_path.read_text())
    root = bench_path.parent
    (cell,) = [w for w in bench["workloads"] if w["name"] == name]
    (config,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    base = root / PACKAGE.name
    limits = base / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=cell["chips"],
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((base / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        limits=json.loads(limits.read_text()) if limits.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def driver(cell: Cell):
    return load_module(PACKAGE / "drivers" / f"{cell.traffic['driver']}.py",
                       f"portbench_driver_{cell.traffic['driver']}")


def reader(metric: str):
    return load_module(PACKAGE / "metrics" / f"{metric}.py",
                       "portbench_metric_" + metric.replace(".", "_"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def quantile(values, q: float) -> float:
    """The q-quantile of ``values``, linearly interpolated between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    return count / seconds


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reports it."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() \
        else None


def device_info(torch, count: int, peak: int, trace=None) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak),
            "power_limit": power_limit()}
    if trace is not None:
        info.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return info


def metrics_of(cell: Cell, outcome: Outcome, trace: bool) -> dict:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones
    that its run holds something to read for."""
    out = {}
    if not trace:
        for m in cell.end_to_end:
            out[m["name"]] = {"value": outcome.metrics[m["name"]],
                              "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = reader(m["name"]).read(outcome)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: Cell, outcome: Outcome, trace: bool, device: dict):
    """The result's JSON object; the compared numbers come last."""
    result = {"correct": bool(outcome.correct),
              "attempted": int(outcome.attempted),
              "failed": int(outcome.failed),
              "metrics": metrics_of(cell, outcome, trace),
              "device": device}
    if trace and outcome.trace is not None:
        result["breakdown"] = outcome.trace.breakdown()
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in outcome.compared.items()}
    return result


def log(ctx, what: str) -> None:
    """A line on standard error: the seconds since the process started
    and what has just ended."""
    print(f"portbench: {time.perf_counter() - ctx.t0:8.2f} s {what}",
          file=sys.stderr, flush=True)


def compared_lines(outcome: Outcome) -> list:
    return [f"compared {k}: {v!r} (limit {lim!r})"
            for k, (v, lim) in outcome.compared.items()]
