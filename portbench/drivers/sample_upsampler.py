"""Sampling traffic for the UNet upsampler (``train_upsampler=True``, no
discriminator): one client in a closed loop, each request one
``GigaGAN.generate(lowres, seed=s)`` call, timed from the call to the
numpy array it returns.  ``lowres`` is a fresh host float32 (b, n, n, 3)
image, the next items of ``SeededImages(n, seed)``, and ``s`` a fresh
seed; b is the traffic's ``batch`` and n its ``lowres_size``.

The sample driver (``drivers/sample.py``: set-up's warm requests, the
window, the reservoir of kept requests, the comparison that decides
``correct``, ``readings`` and ``control``) is loaded once more under a
name of its own, and in that copy alone:

- set-up builds ``GigaGAN(generator=..., train_upsampler=True, amp=...)``
  with no discriminator (``program.build(sampler=True)`` drops the
  trainer's options, and would build the base generator);
- the request stream hands out (seed, low-res image) pairs, in the slot
  where the sample driver carries captions;
- the reference is ``reference/upsampler_sampler.py``: the float32 UNet
  from the same weights, low-res image and latent seed;
- set-up also reads ``latent_gap``: the style latent the program drew in
  LATENT_REQUESTS requests (the input of its G's style network, recorded
  by a hook taken off before the window) against the reference's draw
  from each request's seed, the largest gap over the reference's largest
  value (0 when they agree bitwise).  At random weights the latent moves
  the output no more than bf16's rounding does, so the images' numbers
  cannot tell a latent drawn from another seed; this number can.  The
  control's latent is the reference's own: its ``latent_gap`` is 0;
- the traced window (``Traced``) also records the kernel entries' calls
  (``program.CallRecorder``: K1's and K3's bounds, for their rooflines)
  and, as ``attribution.Traced`` does, the device seconds of the
  ``gigagan.up.*`` spans and the linear attention's bound.

The base driver of the other cells is not touched.  Importing this module
adds the fault ``other-latent`` to ``faults.FAULTS`` (for ``readings.py
--mode other-latent``): each request's style latent drawn from another
seed than the request's."""

from __future__ import annotations

import numpy as np

from portbench import attribution, checks, faults, harness, program
from portbench.data import SeededImages
from portbench.flops import CountFlops
from portbench.harness import quantile
from portbench.reference import numerics as nm
from portbench.reference import upsampler_sampler

_sample = harness.load_module(harness.PACKAGE / "drivers" / "sample.py",
                              "portbench_driver_sample_for_upsampler")
LATENT_REQUESTS = 2


class Requests:
    """Each request's seed and low-res images, drawn from one seed."""

    def __init__(self, seed: int, batch: int, lowres_size: int):
        self.rng = np.random.default_rng(seed)
        self.images = SeededImages(lowres_size, seed)
        self.batch = batch
        self.served = 0

    def next(self):
        s = int(self.rng.integers(2 ** 63))
        lowres = np.stack([self.images[self.served + i]
                           for i in range(self.batch)])
        self.served += self.batch
        return s, lowres


def _requests(ctx, seed):
    traffic = ctx.cell.traffic
    return Requests(seed, traffic["batch"], traffic["lowres_size"])


def _call(gan, s, lowres, batch):
    return gan.generate(lowres, seed=s)


def build(config: dict, *, seed: int, device, out):
    """The port's sampler of the upsampler: G and its EMA copy, no D."""
    from gigagan_tpu_torch import GigaGAN

    return GigaGAN(generator=config["generator"], amp=config["amp"],
                   seed=seed, device=device,
                   model_folder=str(out / "models"),
                   results_folder=str(out / "results"),
                   **config.get("trainer", {}), **program.NO_SAVES)


def setup(ctx, seeds):
    """The sampler with the seed's weights, warmed on the request's
    shapes, and the request stream."""
    torch = ctx.torch
    cfg = ctx.cell.config
    gan = build(cfg, seed=seeds["trainer"], device=ctx.device, out=ctx.out)
    with torch.no_grad():
        models = upsampler_sampler.make_weights(cfg, seeds["weights"],
                                                ctx.device)
        program.load_weights(gan, models)
        del models
    ctx.plant(gan)
    requests = _requests(ctx, seeds["requests"])
    for _ in range(_sample.WARM_REQUESTS):
        _call(gan, *requests.next(), requests.batch)
    ctx.latent_gap = latent_gap(ctx, gan, requests)
    return gan, requests


def latent_gap(ctx, gan, requests) -> float:
    """The program's style latents of LATENT_REQUESTS requests against the
    reference's draws from their seeds: max |got − want| / max |want|
    (infinite where a request drew none)."""
    torch = ctx.torch
    drawn, wanted = [], []
    hook = gan.G_ema.style_net.register_forward_pre_hook(
        lambda module, args: drawn.append(args[0].float().cpu()))
    try:
        for _ in range(LATENT_REQUESTS):
            s, lowres = requests.next()
            _call(gan, s, lowres, requests.batch)
            wanted.append((s, len(lowres)))
    finally:
        hook.remove()
    if len(drawn) != len(wanted):
        return float("inf")
    cfg = ctx.cell.config
    dim = cfg["generator"]["style_network"]["dim"]
    with nm.numerics(draw_dtype=torch.bfloat16 if cfg["amp"]
                     else torch.float32):
        want = [upsampler_sampler.latent(s, b, dim, ctx.device).cpu()
                for s, b in wanted]
    return max(checks.pixel_gap(g.numpy(), w.numpy())
               for g, w in zip(drawn, want))


def _compare(ctx, got, want) -> dict:
    """The sample driver's numbers of the kept requests' images, and the
    run's ``latent_gap``."""
    images = list(map(checks.image_gap, got, want))
    pixels = list(map(checks.pixel_gap, got, want))
    numbers = {"image_gap": max(images), "pixel_gap": max(pixels),
               "image_median_gap": quantile(images, 0.5),
               "pixel_median_gap": quantile(pixels, 0.5),
               "latent_gap": ctx.latent_gap}
    return checks.compared(numbers, ctx.cell.limits)


def control(ctx) -> dict:
    """The sample driver's control: the reference in fp8 in the program's
    place, whose latent is the reference's own draw."""
    ctx.latent_gap = 0.0
    return _sample.control(ctx)


def reference_images(ctx, seeds, kept, *, fp8: bool = False):
    """The reference's output for each kept (seed, low-res image, _)."""
    torch = ctx.torch
    cfg = ctx.cell.config
    draw = torch.bfloat16 if cfg["amp"] else torch.float32
    out = []
    with nm.numerics(draw_dtype=draw, fp8=fp8), torch.no_grad():
        models = upsampler_sampler.make_weights(cfg, seeds["weights"],
                                                ctx.device)
        for s, lowres, _ in kept:
            out.append(upsampler_sampler.generate(models, s, lowres)
                       .cpu().numpy())
        del models
    return out


def sample_flops(ctx, seeds) -> float:
    """The operations one request requires: the reference's products and
    convolutions (``flops.CountFlops``) over one request."""
    torch = ctx.torch
    s, lowres = _requests(ctx, seeds["requests"]).next()
    with torch.no_grad():
        models = upsampler_sampler.make_weights(ctx.cell.config,
                                                seeds["weights"], ctx.device)
        with CountFlops() as counter:
            upsampler_sampler.generate(models, s, lowres)
    return float(counter.total)


class Traced(attribution.Traced):
    """``attribution.Traced`` that also records the kernel entries' calls
    while open, and leaves their bounds on its summary as ``calls``."""

    def __enter__(self):
        if self.on:
            self._recorder = program.CallRecorder().__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self.on:
            self._recorder.__exit__(*exc)
            if self.summary is not None:
                self.summary.calls = {"bound_s": self._recorder.bound_s,
                                      "calls": self._recorder.calls}
        return False


def other_latent(gan) -> None:
    """Each request's style latent drawn from another seed than the
    request's (the next one)."""
    generate = gan.generate

    def shifted(*a, seed, **k):
        return generate(*a, seed=seed + 1, **k)

    gan.generate = shifted


faults.FAULTS.setdefault("other-latent", other_latent)

_sample.setup = setup
_sample._requests = _requests
_sample._call = _call
_sample.reference_images = reference_images
_sample._compare = _compare
_sample.sample_flops = sample_flops
_sample.Traced = Traced

readings = _sample.readings


def run(ctx):
    """The sample driver's run, with the traced window's kernel calls on
    the outcome (for the ``*_roofline.sample`` readers)."""
    outcome = _sample.run(ctx)
    if outcome.trace is not None:
        outcome.calls = outcome.trace.calls
    return outcome
