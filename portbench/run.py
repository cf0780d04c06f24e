"""Run one cell of the benchmark once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json ``workloads``) names a configuration and a
traffic mix; the traffic names its driver.  The last line of standard
output is the result's JSON object; the numbers compared against the
plain reference are also the last lines of standard error.  Without a
CUDA card, or with fewer cards than the cell asks for, or with JAX or
the JAX package loaded, it exits non-zero and prints no result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / "out" / "cache"


class Context:
    """What a driver gets: the cell, the run's settings, the torch module
    and the device."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device, t0: float, out: Path, plant=None):
        import torch

        self.torch = torch
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t0 = t0
        self.out = out
        self._plant = plant

    def seeds(self, *names) -> dict:
        """One seed per name, each drawn from the run's seed."""
        import numpy as np

        states = np.random.SeedSequence(self.seed % 2 ** 64).generate_state(
            len(names), np.uint64)
        return {n: int(s) % 2 ** 63 for n, s in zip(names, states)}

    def plant(self, system) -> None:
        """A test's fault planted in the system under test (no-op in a
        benchmark run)."""
        if self._plant is not None:
            self._plant(system)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from gigagan_tpu_torch.ops.kernels import build

    build.build_all()
    out = harness.OUT / "run"
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda"), T0, out)
    outcome = harness.driver(cell).run(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}: the benchmark must "
              "not load JAX or the JAX package", file=sys.stderr)
        return 3
    device = harness.device_info(torch, cell.chips, outcome.device_peak_bytes,
                                 outcome.trace if args.trace else None)
    print(json.dumps({"launch_counters": outcome.counters}), flush=True)
    result = harness.result_line(cell, outcome, bool(args.trace), device)
    for line in harness.compared_lines(outcome):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
