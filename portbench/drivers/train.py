"""Training traffic: the user's entry, ``GigaGAN.forward(steps=N)``, in one
call of whole 4-iteration cadences (three d_steps, one d_step with the R1
penalty, four g_steps), fed by the port's ``DataLoader`` over the
benchmark's seeded images (and captions, for a text-conditioned
configuration).

Set-up builds the trainer, loads the weights drawn from the seed, and
drives its first three iterations through that same call and feed (steps
4, 5 and 6: the first takes the R1 penalty); a whole cadence more warms
up and sizes the window.  After the window the reference follows the
same three iterations from the same weights, batches and step seeds, and
the two are compared:

- ``loss_gap``: each step's losses, the gap of each as a share of the
  reference's loss, or of the median loss of that step if larger;
- ``grad_gap``: per leaf, the norm of the first step's gradient as the
  optimizer took it (from Adam's first moment); the gap of the norms as a
  share of the reference's norm of that leaf, or of the median leaf's if
  larger; the worst leaf of G, D and VD (``grad_gap``), the median leaf
  (``grad_median_gap``) and the 90th-percentile leaf (``grad_p90_gap``);
- ``change_gap``: the same of each leaf's change over the three steps
  (G_ema's too), leaving out leaves whose reference first gradient is
  under a thousandth of the median leaf's (they move by round-off)."""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np

from portbench import checks
from portbench.flops import CountFlops
from portbench import program
from portbench.data import SeededImages
from portbench.harness import Outcome, log, rate
from portbench.reference import numerics as nm
from portbench.reference import trainer as ref_trainer
from portbench.trace import Traced

CHECK_STEPS = 3
CADENCE = 4
# cadences in the traced window (its per-layer readings are ratios)
TRACE_CADENCES = 1
# the FLOP count's batch (every counted operation is per sample)
FLOP_BATCH = 2


def _loader(ctx, cfg, traffic, seed, batch):
    from gigagan_tpu_torch.data import DataLoader, collate_tensors_or_str

    conditional = not cfg["generator"].get("unconditional", False)
    words = traffic["captions"]["words"] if conditional else None
    caps = traffic.get("captions", {})
    dataset = SeededImages(cfg["generator"]["image_size"], seed,
                           words=words,
                           min_words=caps.get("min_words", 4),
                           max_words=caps.get("max_words", 16))
    return DataLoader(dataset, batch, shuffle=True, drop_last=True,
                      seed=seed,
                      collate_fn=collate_tensors_or_str if conditional
                      else None)


def program_check(ctx, gan, seeds):
    """Drive the first CHECK_STEPS iterations through ``forward`` and read
    the program's numbers; returns (numbers, the batches fed)."""
    torch = ctx.torch
    mods = program.modules(gan)
    probe = program.StepProbe(gan, mods)
    gan.forward(steps=CHECK_STEPS)
    probe.close()
    torch.cuda.synchronize() if ctx.device.type == "cuda" else None
    losses = [{k: float(v) for k, v in step.items()} for step in probe.losses]
    first = {k: {n: float(v) for n, v in leaves.items()}
             for k, leaves in probe.first.items()}
    with torch.no_grad():
        state0 = ref_trainer.make_weights(ctx.cell.config, seeds["weights"],
                                          ctx.device)
        change = {}
        for key, (module, _) in mods.items():
            ref_state = state0[key].state_dict()
            change[key] = {n: float(v) for n, v in program.change_norms(
                module.named_parameters(), ref_state).items()}
        change["G_ema"] = {n: float(v) for n, v in program.change_norms(
            gan.G_ema.named_parameters(), state0["G"].state_dict()).items()}
        del state0
    return {"losses": losses, "first": first, "change": change}


def reference_check(ctx, seeds, batches, *, fp8: bool = False):
    """The reference's numbers over the same iterations (computed in fp8
    for the control)."""
    torch = ctx.torch
    cfg = ctx.cell.config
    draw = torch.bfloat16 if cfg["amp"] else torch.float32
    with nm.numerics(draw_dtype=draw, fp8=fp8):
        models = ref_trainer.make_weights(cfg, seeds["weights"], ctx.device)
        with torch.no_grad():
            state0 = {k: {n: t.clone() for n, t in m.state_dict().items()}
                      for k, m in models.items()
                      if k in ("G", "D", "VD") and m is not None}
        ref = ref_trainer.ReferenceTrainer(models, cfg,
                                           seed=seeds["trainer"],
                                           device=ctx.device)
        ref.steps = ctx.cell.traffic.get("first_step", CADENCE)
        mods = {"G": (ref.G, ref.g_opt), "D": (ref.D, ref.d_opt)}
        if ref.VD is not None:
            mods["VD"] = (ref.VD, ref.vd_opt)
        losses, first = [], {}
        for i in range(CHECK_STEPS):
            d, g = ref.iteration(batches[2 * i], batches[2 * i + 1],
                                 rows=ctx.cell.traffic.get("reference_rows"))
            losses.append({**{f"d_{k}": float(v) for k, v in d.items()},
                           **{f"g_{k}": float(v) for k, v in g.items()}})
            if i == 0:
                for key, (module, opt) in mods.items():
                    first[key] = {n: float(v) for n, v in
                                  program.first_grad_norms(
                                      list(module.named_parameters()), opt,
                                      opt.param_groups[0]["betas"][0]
                                  ).items()}
        with torch.no_grad():
            change = {key: {n: float(v) for n, v in program.change_norms(
                module.named_parameters(), state0[key]).items()}
                for key, (module, _) in mods.items()}
            change["G_ema"] = {n: float(v) for n, v in program.change_norms(
                ref.G_ema.named_parameters(), state0["G"]).items()}
    return {"losses": losses, "first": first, "change": change}


def _free(torch):
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def setup(ctx, seeds):
    """The trainer with the seed's weights, its feed, its steps counter at
    the traffic's first step, and any planted fault."""
    torch = ctx.torch
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    gan = program.build(cfg, seed=seeds["trainer"], device=ctx.device,
                        out=ctx.out)
    with torch.no_grad():
        models = ref_trainer.make_weights(cfg, seeds["weights"], ctx.device)
        program.load_weights(gan, models)
        del models
    feed = program.Feed(_loader(ctx, cfg, traffic, seeds["data"],
                                traffic["batch"]), keep=2 * CHECK_STEPS)
    gan.set_dataloader(feed)
    gan.steps = traffic.get("first_step", CADENCE)
    ctx.plant(gan)
    return gan, feed


def readings(ctx) -> dict:
    """The compared numbers of the program's first iterations alone (no
    window): what a run's check reads, for setting the limits."""
    seeds = ctx.seeds("weights", "trainer", "data")
    gan, feed = setup(ctx, seeds)
    mine = program_check(ctx, gan, seeds)
    batches = feed.batches
    del gan, feed
    _free(ctx.torch)
    ref = reference_check(ctx, seeds, batches)
    checks.log_losses(mine, ref)
    print("portbench: worst leaves", json.dumps(checks.worst_leaves(
        mine, ref)), file=sys.stderr)
    return checks.train_numbers(mine, ref, ctx.cell.limits)


def run(ctx) -> Outcome:
    torch = ctx.torch
    batch = ctx.cell.traffic["batch"]
    seeds = ctx.seeds("weights", "trainer", "data")
    cuda = ctx.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    gan, feed = setup(ctx, seeds)
    log(ctx, "built the trainer and loaded the weights")
    mine = program_check(ctx, gan, seeds)
    log(ctx, f"the first {CHECK_STEPS} iterations")

    sync()
    t = time.perf_counter()
    gan.forward(steps=CADENCE)
    sync()
    cadence_s = time.perf_counter() - t
    cadences = max(1, round(ctx.seconds / cadence_s))
    iterations = CADENCE * cadences
    log(ctx, f"a warm-up cadence of {cadence_s:.3f} s")

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t = time.perf_counter()
    setup_s = t - ctx.t0
    gan.forward(steps=iterations)
    sync()
    window_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    images = iterations * batch
    metrics = {"train_img_per_s": rate(images, window_s),
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    log(ctx, f"the window: {iterations} iterations in {window_s:.3f} s")

    summary, calls, traced_iterations = None, {}, 0
    if ctx.trace:
        traced_iterations = CADENCE * TRACE_CADENCES
        with program.CallRecorder() as rec, Traced(torch, True) as tr:
            gan.forward(steps=traced_iterations)
        summary = tr.summary
        calls = {"bound_s": rec.bound_s, "calls": rec.calls}
        log(ctx, f"the traced window ({summary.window_s:.3f} s) and its "
            "reading")
    counters = program.launch_counters()
    batches = feed.batches
    del gan, feed
    _free(torch)
    held = torch.cuda.memory_allocated() if cuda else 0
    log(ctx, f"freed the trainer ({held / 2 ** 30:.3f} GiB still held)")

    ref = reference_check(ctx, seeds, batches)
    compared = checks.train_numbers(mine, ref, ctx.cell.limits)
    checks.log_losses(mine, ref)
    log(ctx, "the reference's iterations")
    flops = None
    if ctx.trace:
        flops = train_flops_per_image(ctx, seeds)
        log(ctx, "the operation count")
    return Outcome(
        correct=all(v <= lim for v, lim in compared.values()),
        attempted=iterations, failed=0, metrics=metrics,
        compared=compared, device_peak_bytes=peak, kind="train",
        units=traced_iterations, flops_per_unit=flops,
        rate_units_per_s=metrics["train_img_per_s"], trace=summary,
        calls=calls, counters=counters)


def control(ctx) -> dict:
    """The control's numbers: the reference in fp8 in the program's place,
    over the same iterations, against the float32 reference."""
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    seeds = ctx.seeds("weights", "trainer", "data")
    loader = _loader(ctx, cfg, traffic, seeds["data"], traffic["batch"])
    it = iter(loader)
    batches = []
    for _ in range(2 * CHECK_STEPS):
        b = next(it)
        batches.append((b[0], list(b[1])) if isinstance(b, tuple)
                       and len(b) == 2 else
                       (b[0] if isinstance(b, tuple) else b, None))
    it.close()
    low = reference_check(ctx, seeds, batches, fp8=True)
    _free(ctx.torch)
    ref = reference_check(ctx, seeds, batches)
    return checks.train_numbers(low, ref, ctx.cell.limits)


def train_flops_per_image(ctx, seeds) -> float:
    """The operations one image of a cadence requires: the reference's
    matrix products and convolutions (``flops.CountFlops``; no
    elementwise op, nothing recomputed) over one cadence at FLOP_BATCH, per image."""
    torch = ctx.torch
    cfg = ctx.cell.config
    models = ref_trainer.make_weights(cfg, seeds["weights"], ctx.device)
    ref = ref_trainer.ReferenceTrainer(models, cfg, seed=seeds["trainer"],
                                       device=ctx.device)
    ref.steps = ctx.cell.traffic.get("first_step", CADENCE)
    conditional = not cfg["generator"].get("unconditional", False)
    size = cfg["generator"]["image_size"]
    rng = np.random.default_rng(seeds["data"])
    words = ctx.cell.traffic.get("captions", {}).get("words")

    def batch():
        images = rng.random((FLOP_BATCH, size, size, 3), dtype=np.float32)
        caps = ([" ".join(rng.choice(words, 6)) for _ in range(FLOP_BATCH)]
                if conditional else None)
        return images, caps

    with CountFlops() as counter:
        for _ in range(CADENCE):
            ref.iteration(batch(), batch())
    total = counter.total
    del ref, models
    _free(torch)
    return total / (CADENCE * FLOP_BATCH)
