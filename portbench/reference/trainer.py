"""The reference trainer and sampler: the models of a configuration built
in float32 from the reference's modules, their weights drawn from a seed
on the device, and the port trainer's loop (``GigaGAN.forward``: a D step
then a G step per iteration, R1 on every 4th step, each step's generators
from the trainer's seeded numpy generator) and sampling
(``GigaGAN.generate``) followed step by step."""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from portbench.reference import numerics as nm
from portbench.reference.clip import CONFIGS, CLIPModel, ClipAdapter
from portbench.reference.discriminator import Discriminator
from portbench.reference.ema import EMA
from portbench.reference.generator import Generator
from portbench.reference.init import init_modules
from portbench.reference.losses import DiffAugment
from portbench.reference.steps import TrainSteps
from portbench.reference.vision_aided import VisionAidedDiscriminator

LOSS_WEIGHTS = dict(discr_aux_recon_loss_weight=1.0,
                    multiscale_divergence_loss_weight=0.1,
                    vision_aided_divergence_loss_weight=0.5,
                    generator_contrastive_loss_weight=0.1,
                    matching_awareness_loss_weight=0.1)
TRAINER_DEFAULTS = dict(learning_rate=2e-4, betas=(0.5, 0.9),
                        apply_gradient_penalty_every=4,
                        calc_multiscale_loss_every=1, **LOSS_WEIGHTS)


def build_models(config: dict, device, *, sampler: bool = False) -> dict:
    """{'G', 'D', 'VD', 'clip'} of ``config`` (absent ones None), float32,
    on ``device``, every parameter and buffer NaN until drawn.  A sampler
    has no discriminators."""
    with torch.device(device):
        models = {"G": Generator(**config["generator"]), "D": None,
                  "VD": None, "clip": None}
        if not sampler:
            models["D"] = Discriminator(**config["discriminator"])
            if config.get("vision_aided_discriminator"):
                models["VD"] = VisionAidedDiscriminator(
                    **config["vision_aided_discriminator"])
        if config.get("clip"):
            spec = config["clip"]
            sizes = {k: v for k, v in spec.items() if k != "name"}
            models["clip"] = CLIPModel(
                dataclasses.replace(CONFIGS[spec["name"]], **sizes))
    with torch.no_grad():
        for m in models.values():
            if m is not None:
                for t in (*m.parameters(), *m.buffers()):
                    t.fill_(float("nan"))
    return models


def make_weights(config: dict, seed: int, device, *,
                 sampler: bool = False) -> dict:
    """The models of ``config`` with the weights of ``seed``: G, D, VD and
    CLIP drawn in that order from one standard normal made on the
    device."""
    models = build_models(config, device, sampler=sampler)
    order = [models[k] for k in ("G", "D", "VD", "clip")
             if models[k] is not None]
    init_modules(order, seed, device)
    for name, m in models.items():
        if m is None:
            continue
        for key, t in m.state_dict().items():
            if not torch.isfinite(t).all():
                raise RuntimeError(f"{name}.{key} was not drawn")
    return models


def step_generators(seed: int, device):
    """(device generator, host generator) from one seed, as the port's
    trainer makes them."""
    s_dev, s_host = np.random.SeedSequence(seed).generate_state(2)
    return (torch.Generator(device=device).manual_seed(int(s_dev)),
            torch.Generator().manual_seed(int(s_host)))


class ReferenceTrainer:
    """The port trainer's alternating loop over reference models.  ``seed``
    is the trainer's: its numpy generator gives each step's seed, as the
    port's does."""

    def __init__(self, models: dict, config: dict, *, seed: int, device):
        opts = {**TRAINER_DEFAULTS, **config.get("trainer", {})}
        self.device = torch.device(device)
        self.models = models
        self.G, self.D, self.VD = models["G"], models["D"], models["VD"]
        for m in (self.G, self.D, self.VD):
            if m is not None:
                m.train()
        self.clip = (ClipAdapter(models["clip"].eval().requires_grad_(False))
                     if models["clip"] is not None else None)
        self.G_ema = copy.deepcopy(self.G).eval().requires_grad_(False)
        self.ema = EMA(self.G_ema)
        self.apply_gp_every = opts["apply_gradient_penalty_every"]
        self.calc_ms_every = opts["calc_multiscale_loss_every"]
        adam = dict(lr=opts["learning_rate"], betas=tuple(opts["betas"]),
                    eps=1e-8)
        self.g_opt = torch.optim.Adam(self.G.parameters(), **adam)
        self.d_opt = torch.optim.Adam(self.D.parameters(), **adam)
        self.vd_opt = (torch.optim.Adam(self.VD.parameters(), **adam)
                       if self.VD is not None else None)
        aug = opts.get("diff_augment")
        self.steps_fn = TrainSteps(
            self.G, self.D, self.g_opt, self.d_opt, ema=self.ema, VD=self.VD,
            vd_opt=self.vd_opt, clip=self.clip,
            diff_augment=DiffAugment(**aug) if aug else None,
            weights={k: opts[k] for k in LOSS_WEIGHTS})
        self.rng = np.random.default_rng(seed)
        self.steps = 1

    def _texts(self, captions):
        if captions is None:
            return None, None
        embed, enc = self.clip.embed_texts(captions)
        return enc, embed

    def iteration(self, d_batch, g_batch, rows=None):
        """One iteration on the loader's two batches, each (images (b, h, w,
        c) in [0, 1], captions or None); returns (D losses, G losses).
        ``rows``: the D step's block of samples (``TrainSteps.d_step``)."""
        step = self.steps
        apply_gp = self.apply_gp_every > 0 and step % self.apply_gp_every == 0
        calc_ms = self.calc_ms_every > 0 and step % self.calc_ms_every == 0
        images, captions = d_batch
        enc, embed = self._texts(captions)
        gen, host = step_generators(int(self.rng.integers(2 ** 63)),
                                    self.device)
        real = torch.as_tensor(np.asarray(images), device=self.device).float()
        d = self.steps_fn.d_step(real, text_encodings=enc, text_embeds=embed,
                                 apply_gp=apply_gp, calc_ms=calc_ms,
                                 generator=gen, host_generator=host,
                                 rows=rows)
        images, captions = g_batch
        enc, embed = self._texts(captions)
        gen, host = step_generators(int(self.rng.integers(2 ** 63)),
                                    self.device)
        g = self.steps_fn.g_step(len(images), text_encodings=enc,
                                 text_embeds=embed, calc_ms=calc_ms,
                                 generator=gen, host_generator=host)
        self.steps += 1
        return d, g


def generate(models: dict, seed: int, captions=None, batch: int = 1):
    """``batch`` samples of G (one per caption when conditional; the
    weights as drawn) with ``seed``'s draws, as ``GigaGAN.generate(seed=
    ...)`` makes them: (batch, h, w, 3) float32 on the device."""
    G = models["G"]
    device = G.init_block.device
    text = None
    if captions is not None:
        text = ClipAdapter(models["clip"]).embed_texts(list(captions))[1]
    s_noise, s_latent = np.random.SeedSequence(seed).generate_state(2)
    noise_gen = torch.Generator(device=device).manual_seed(int(s_noise))
    latent_gen = torch.Generator(device=device).manual_seed(int(s_latent))
    return G(text_encodings=text, batch_size=batch,
             latent_generator=latent_gen,
             noise_generator=noise_gen)


__all__ = ["ReferenceTrainer", "build_models", "generate", "make_weights",
           "nm", "step_generators"]
