"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference, each as one number held to its limit
(``limits/<cell>.json``).  A number that is not a finite reading (a NaN,
a missing leaf) reads infinite, so it fails."""

from __future__ import annotations

import json
import math
import statistics
import sys

# a leaf whose reference first gradient is under this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared
STILL_LEAF = 1e-3


def _gap(got, want, scale) -> float:
    if got is None or not math.isfinite(got):
        return math.inf
    return abs(got - want) / scale if scale > 0 else (
        0.0 if got == want else math.inf)


def _median(values) -> float:
    values = [v for v in values if v > 0]
    return statistics.median(values) if values else 0.0


def leaf_gaps(mine: dict, ref: dict, skip=()) -> list:
    """Per leaf, the gap of the norms against the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    med = _median(ref.values())
    return [_gap(mine.get(name), want, max(want, med))
            for name, want in ref.items() if name not in skip]


def step_gap(got: dict, want: dict) -> float:
    """The worst loss of a step against the reference's, each against the
    reference's loss or the median nonzero loss of that step."""
    med = _median([abs(v) for v in want.values()])
    return max((_gap(got.get(name), w, max(abs(w), med))
                for name, w in want.items()), default=0.0)


def still_leaves(first_ref: dict) -> set:
    med = _median(first_ref.values())
    return {n for n, v in first_ref.items() if v < STILL_LEAF * med}


def train_readings(mine: dict, ref: dict) -> dict:
    """Every number a train cell can compare: per step its losses' gap
    (all, D's and G's), per module the first gradient's worst, median and
    90th-percentile leaf and the change's worst and median leaf, and the
    worst of each over steps or modules."""
    out = {}
    if len(mine["losses"]) != len(ref["losses"]):
        return {"loss_gap": math.inf}
    for i, (got, want) in enumerate(zip(mine["losses"], ref["losses"])):
        out[f"loss_gap.step{i}"] = step_gap(got, want)
        for side in ("d", "g"):
            part = {k: v for k, v in want.items() if k.startswith(side)}
            out[f"{side}_loss_gap.step{i}"] = step_gap(got, part)
    for key, leaves in ref["first"].items():
        gaps = leaf_gaps(mine["first"].get(key, {}), leaves)
        out[f"grad_gap.{key}"] = max(gaps, default=0.0)
        out[f"grad_median_gap.{key}"] = statistics.median(gaps) \
            if gaps else 0.0
        out[f"grad_p90_gap.{key}"] = statistics.quantiles(
            gaps, n=10, method="inclusive")[8] if len(gaps) > 1 else \
            max(gaps, default=0.0)
    for key, leaves in ref["change"].items():
        first = ref["first"]["G" if key == "G_ema" else key]
        gaps = leaf_gaps(mine["change"].get(key, {}), leaves,
                         skip=still_leaves(first))
        out[f"change_gap.{key}"] = max(gaps, default=0.0)
        out[f"change_median_gap.{key}"] = statistics.median(gaps) \
            if gaps else 0.0
    for name in ("loss_gap", "d_loss_gap", "g_loss_gap", "grad_gap",
                 "change_gap", "change_median_gap"):
        out[name] = max(v for k, v in out.items()
                        if k.startswith(name + "."))
    return out


def compared(readings: dict, limits: dict) -> dict:
    """The numbers the cell's limits name, each with its limit (every
    reading, against 0, where no limit is set yet)."""
    if not limits:
        return {k: (v, 0.0) for k, v in readings.items()}
    return {k: (readings.get(k, math.inf), lim) for k, lim in limits.items()}


def train_numbers(mine: dict, ref: dict, limits: dict) -> dict:
    return compared(train_readings(mine, ref), limits)


def image_gap(got, want) -> float:
    """‖got − want‖ / ‖want‖ of one sample (numpy arrays)."""
    import numpy as np

    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def pixel_gap(got, want) -> float:
    """max |got − want| / max |want| of one sample: the widest gap of any
    pixel."""
    import numpy as np

    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    return float(np.abs(got - want).max() / np.abs(want).max())


def log_losses(mine: dict, ref: dict) -> None:
    """Each step's losses, the program's beside the reference's, on
    standard error."""
    for i, (got, want) in enumerate(zip(mine["losses"], ref["losses"])):
        print("portbench: losses of step", i, json.dumps(
            {k: [got.get(k), w] for k, w in want.items()}), file=sys.stderr)


def worst_leaves(mine: dict, ref: dict) -> dict:
    """Per module, the leaf of the worst first-gradient gap and of the
    worst change gap, with the two norms: what a look at a high reading
    starts from."""
    out = {}
    for part in ("first", "change"):
        for key, leaves in ref[part].items():
            skip = (still_leaves(ref["first"]["G" if key == "G_ema"
                                              else key])
                    if part == "change" else ())
            names = [n for n in leaves if n not in skip]
            gaps = leaf_gaps(mine[part].get(key, {}), {n: leaves[n]
                                                        for n in names})
            if gaps:
                i = max(range(len(gaps)), key=gaps.__getitem__)
                out[f"{part}.{key}"] = [names[i], gaps[i],
                                        mine[part].get(key, {}).get(names[i]),
                                        leaves[names[i]]]
    return out
