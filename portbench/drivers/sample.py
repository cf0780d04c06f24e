"""Sampling traffic: one client in a closed loop, each request one
``GigaGAN.generate(batch_size=b, seed=...)`` call with a fresh seed (and,
for a text-conditioned configuration, ``texts=[b captions]``, so that
CLIP's tokenizer and text tower are inside the request), timed from the
call to the numpy array it returns; b is the traffic's ``batch``.

Set-up builds the sampler (G and its EMA copy; CLIP), loads the weights
drawn from the seed and warms the request's shapes.  The window runs
requests until ``--seconds`` have passed; a sample of them, drawn from
the seed, is kept.  After the window the reference makes each kept
request's images from the same weights, captions and seed: per request
``image`` is ‖program − reference‖ / ‖reference‖ and ``pixel`` the worst
pixel's gap over the reference's largest pixel; ``*_gap`` is the worst
kept request's, ``*_median_gap`` the median kept request's."""

from __future__ import annotations

import gc
import time

import numpy as np

from portbench import checks
from portbench.flops import CountFlops
from portbench import program
from portbench.data import caption
from portbench.harness import Outcome, log, quantile, rate
from portbench.reference import numerics as nm
from portbench.reference import trainer as ref_trainer
from portbench.trace import Traced

WARM_REQUESTS = 10
KEPT = 16
# the traced window's length (its per-layer readings are ratios)
TRACE_SECONDS = 3.0


class Requests:
    """Each request's seed and captions, drawn from one seed."""

    def __init__(self, seed: int, batch: int, words, min_words: int,
                 max_words: int):
        self.rng = np.random.default_rng(seed)
        self.batch = batch
        self.words = words
        self.min_words, self.max_words = min_words, max_words

    def next(self):
        s = int(self.rng.integers(2 ** 63))
        caps = ([caption(self.rng, self.words, self.min_words,
                         self.max_words) for _ in range(self.batch)]
                if self.words else None)
        return s, caps


def _requests(ctx, seed):
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    conditional = not cfg["generator"].get("unconditional", False)
    caps = traffic.get("captions", {})
    return Requests(seed, traffic["batch"],
                    caps.get("words") if conditional else None,
                    caps.get("min_words", 4), caps.get("max_words", 16))


def _call(gan, s, caps, batch):
    if caps is None:
        return gan.generate(batch_size=batch, seed=s)
    return gan.generate(texts=caps, seed=s)


def reference_images(ctx, seeds, kept, *, fp8: bool = False):
    torch = ctx.torch
    cfg = ctx.cell.config
    draw = torch.bfloat16 if cfg["amp"] else torch.float32
    out = []
    with nm.numerics(draw_dtype=draw, fp8=fp8), torch.no_grad():
        models = ref_trainer.make_weights(cfg, seeds["weights"], ctx.device,
                                          sampler=True)
        for s, caps, image in kept:
            out.append(ref_trainer.generate(models, s, caps, len(image))
                       .cpu().numpy())
        del models
    return out


def setup(ctx, seeds):
    """The sampler with the seed's weights, warmed on the request's
    shapes, and the request stream."""
    torch = ctx.torch
    gan = program.build(ctx.cell.config, seed=seeds["trainer"],
                        device=ctx.device, out=ctx.out, sampler=True)
    with torch.no_grad():
        models = ref_trainer.make_weights(ctx.cell.config, seeds["weights"],
                                          ctx.device, sampler=True)
        program.load_weights(gan, models)
        del models
    ctx.plant(gan)
    requests = _requests(ctx, seeds["requests"])
    for _ in range(WARM_REQUESTS):
        _call(gan, *requests.next(), requests.batch)
    return gan, requests


def readings(ctx) -> dict:
    """The compared number over KEPT requests of the program alone (no
    window), for setting the limit."""
    seeds = ctx.seeds("weights", "trainer", "requests", "kept")
    gan, requests = setup(ctx, seeds)
    kept = [(s, caps, _call(gan, s, caps, requests.batch))
            for s, caps in (requests.next() for _ in range(KEPT))]
    del gan
    gc.collect()
    return _compare(ctx, [img for _, _, img in kept],
                    reference_images(ctx, seeds, kept))


def _compare(ctx, got, want) -> dict:
    images = list(map(checks.image_gap, got, want))
    pixels = list(map(checks.pixel_gap, got, want))
    numbers = {"image_gap": max(images), "pixel_gap": max(pixels),
               "image_median_gap": quantile(images, 0.5),
               "pixel_median_gap": quantile(pixels, 0.5)}
    return checks.compared(numbers, ctx.cell.limits)


def run(ctx) -> Outcome:
    torch = ctx.torch
    seeds = ctx.seeds("weights", "trainer", "requests", "kept")
    cuda = ctx.device.type == "cuda"
    gan, requests = setup(ctx, seeds)
    log(ctx, "built the sampler, loaded the weights, warmed up")

    keep_rng = np.random.default_rng(seeds["kept"])
    kept, latencies = [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t0
    while time.perf_counter() - t0 < ctx.seconds:
        s, caps = requests.next()
        t = time.perf_counter()
        image = _call(gan, s, caps, requests.batch)
        latencies.append(time.perf_counter() - t)
        # a uniform sample of KEPT requests (reservoir sampling)
        n = len(latencies)
        if len(kept) < KEPT:
            kept.append((s, caps, image))
        else:
            j = int(keep_rng.integers(n))
            if j < KEPT:
                kept[j] = (s, caps, image)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(ctx, f"the window: {len(latencies)} requests in {window_s:.3f} s")
    tenth = max(1, len(latencies) // 10)
    log(ctx, "median ms of each tenth of the window's requests: " + " ".join(
        f"{quantile(latencies[i:i + tenth], 0.5) * 1e3:.2f}"
        for i in range(0, len(latencies) - tenth + 1, tenth)))
    metrics = {"sample_ms_p50": quantile(latencies, 0.5) * 1e3,
               "sample_ms_p95": quantile(latencies, 0.95) * 1e3,
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}

    summary, traced = None, 0
    if ctx.trace:
        with Traced(torch, True) as tr:
            t = time.perf_counter()
            while time.perf_counter() - t < min(ctx.seconds, TRACE_SECONDS):
                _call(gan, *requests.next(), requests.batch)
                traced += 1
        summary = tr.summary
        log(ctx, f"the traced window ({traced} requests) and its reading")
    counters = program.launch_counters()
    del gan
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    compared = _compare(ctx, [img for _, _, img in kept],
                        reference_images(ctx, seeds, kept))
    log(ctx, f"the reference's {len(kept)} images")
    flops = sample_flops(ctx, seeds) if ctx.trace else None
    return Outcome(
        correct=all(v <= lim for v, lim in compared.values()),
        attempted=len(latencies), failed=0, metrics=metrics,
        compared=compared, device_peak_bytes=peak, kind="sample",
        units=traced, flops_per_unit=flops,
        rate_units_per_s=rate(len(latencies), window_s), trace=summary,
        counters=counters)


def control(ctx) -> dict:
    """The control's number: the reference in fp8 in the program's place
    on KEPT requests, against the float32 reference."""
    seeds = ctx.seeds("weights", "trainer", "requests", "kept")
    requests = _requests(ctx, seeds["requests"])
    kept = [(*requests.next(), np.empty(requests.batch))
            for _ in range(KEPT)]
    low = reference_images(ctx, seeds, kept, fp8=True)
    return _compare(ctx, low, reference_images(ctx, seeds, kept))


def sample_flops(ctx, seeds) -> float:
    """The operations one request requires: the reference's products and
    convolutions (``flops.CountFlops``) over one request."""
    torch = ctx.torch
    requests = _requests(ctx, seeds["requests"])
    s, caps = requests.next()
    with torch.no_grad():
        models = ref_trainer.make_weights(ctx.cell.config, seeds["weights"],
                                          ctx.device, sampler=True)
        with CountFlops() as counter:
            ref_trainer.generate(models, s, caps, requests.batch)
    return float(counter.total)
