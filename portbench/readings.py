"""The readings the limits of ``limits/<cell>.json`` are set from, one
process for many seeds (set-up is paid once per seed, no window):

    python3 portbench/readings.py --workload <cell> --mode <mode> \
        --seeds 1,2,3 [--out portbench/out/readings.jsonl]

``program``: the system under test against the reference, as a run's
check reads it; ``control``: the reference in fp8 in the program's place;
``unchanged``, ``half-batch``, ``altered``: the program with that fault
planted (``faults.py``); ``fp32``: the program with amp off (a witness
that tells rounding from a fault).  One JSON line per seed.  The benchmark's runs do
not run this."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import faults, harness
    from portbench.run import Context

    cell = harness.resolve(args.workload)
    cell.limits = {}  # every reading, not only those the limits name
    if args.mode == "fp32":
        cell.config = {**cell.config, "amp": False}
    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA card", file=sys.stderr)
        return 2
    from gigagan_tpu_torch.ops.kernels import build

    build.build_all()
    driver = harness.driver(cell)
    plant = faults.FAULTS.get(args.mode)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = Context(cell, seed, 0.0, False, torch.device("cuda"), T0,
                      harness.OUT / "readings", plant=plant)
        numbers = (driver.control(ctx) if args.mode == "control"
                   else driver.readings(ctx))
        torch.cuda.empty_cache()
        line = json.dumps({"workload": cell.name, "mode": args.mode,
                           "seed": seed,
                           "numbers": {k: v for k, (v, _) in numbers.items()},
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
