"""Training-health run of the port: the README quickstart pair (256px G+D,
bf16, batch 8) on ``SyntheticShapesDataset(256, length=512, seed=7)``, as
the JAX package's ``scripts/health_run.py`` runs it.

    python3 -m gigagan_tpu_torch.health_run [steps] [--out DIR]

Runs on the CUDA device (2000 steps by default).  Every 20 steps the
trainer's ``log_hook`` record (the 10 losses, ``ms_per_step``,
``images_per_sec``) goes to ``DIR/losses.jsonl``; at every quarter
milestone the raw and EMA sample grids go to ``DIR`` (``DIR`` defaults to
``chiprun_out/health``).  The checkpoints of the save cadence go to
``gigagan-models/health`` and are deleted at the end.  It ends with the
curve at the steps the JAX run reported, the device's name and power
limit, and fails if a loss or a parameter is not finite.

The oracle (the reference README and the JAX run's curve in DESIGN.md): no
NaN; G settles to about 0-10; the aux reconstruction loss (SSL) decays
from about 4 toward 0.06; the R1 penalty (GP) rises to a peak and then
decays.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
from pathlib import Path

# the README quickstart (bench.py:120-135)
QUICKSTART_G = dict(image_size=256, dim_capacity=8, dim_max=512,
                    style_network=dict(dim=64, depth=4),
                    num_skip_layers_excite=4, unconditional=True)
QUICKSTART_D = dict(image_size=256, dim_capacity=16, dim_max=512,
                    num_skip_layers_excite=4, unconditional=True)
CURVE_STEPS = (1, 20, 160, 300, 440, 500, 1000, 1500, 2000)
MILESTONES = 4


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("steps", nargs="?", type=int, default=2000)
    parser.add_argument("--out", default="chiprun_out/health")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from gigagan_tpu_torch import GigaGAN
    from gigagan_tpu_torch.data import SyntheticShapesDataset

    if not torch.cuda.is_available():
        raise SystemExit("health_run: no CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"gpu: {gpu}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    models = Path("gigagan-models/health")
    curve = []
    with open(out / "losses.jsonl", "w", buffering=1) as f:
        def log_hook(record):
            curve.append(record)
            f.write(json.dumps(record) + "\n")

        gan = GigaGAN(
            generator=QUICKSTART_G, discriminator=QUICKSTART_D, amp=True,
            model_folder=str(models), results_folder=str(out),
            log_steps_every=20, num_samples=16,
            save_and_sample_every=max(args.steps // MILESTONES, 1),
            early_save_thres_steps=0, seed=0, log_hook=log_hook,
        )
        data = SyntheticShapesDataset(256, length=512, seed=7)
        gan.set_dataloader(data.get_dataloader(8))
        chunk = max(args.steps // MILESTONES, 1)
        done = 0
        while done < args.steps:
            n = min(chunk, args.steps - done)
            gan.forward(steps=n)
            done += n
    shutil.rmtree(models, ignore_errors=True)

    finite = all(bool(torch.isfinite(p).all())
                 for m in (gan.G, gan.D) for p in m.parameters())
    losses_finite = all(math.isfinite(v) for r in curve for v in r.values())
    at = {r["step"]: r for r in curve}
    summary = {"gpu": gpu, "device": torch.cuda.get_device_name(0),
               "steps": args.steps, "params_finite": finite,
               "losses_finite": losses_finite,
               "curve": [at[s] for s in CURVE_STEPS if s in at],
               "gp_peak": max(curve, key=lambda r: r["GP"]),
               "ms_per_step_median": float(np.median(
                   [r["ms_per_step"] for r in curve[1:]] or [0.0]))}
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    for r in summary["curve"]:
        print("curve " + json.dumps(r), flush=True)
    print(f"GP peak at step {summary['gp_peak']['step']}: "
          f"{summary['gp_peak']['GP']:.2f}; median ms/step "
          f"{summary['ms_per_step_median']:.2f} [{gpu}]", flush=True)
    if not (finite and losses_finite):
        raise SystemExit("health_run: FAIL: non-finite losses or parameters")
    print("HEALTH RUN OK", flush=True)


if __name__ == "__main__":
    main()
