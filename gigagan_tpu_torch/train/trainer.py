"""``GigaGAN`` (counterpart of gigagan_tpu/train/trainer.py): builds G, its
EMA copy and, for training, the unconditional discriminator from the same
``generator=dict(...)``, ``discriminator=dict(...)``, ``amp=`` and
``seed=`` arguments; both optimizers (the JAX trainer's defaults: Adam,
lr 2e-4, betas (0.5, 0.9), no weight decay); ``train_discriminator_step``,
``train_generator_step`` and a ``train(steps)`` loop with R1 every 4th
step; JAX parameters through the weight bridge; and sampling.

Options of the JAX trainer that this port does not have yet raise
``NotImplementedError`` (ROADMAP.md Queue 1)."""

from __future__ import annotations

import copy
import time
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from gigagan_tpu_torch.convert import convert_params
from gigagan_tpu_torch.data import cycle
from gigagan_tpu_torch.losses import DiffAugment
from gigagan_tpu_torch.models.discriminator import Discriminator
from gigagan_tpu_torch.models.generator import Generator
from gigagan_tpu_torch.models.layers import init_parameters
from gigagan_tpu_torch.train.ema import EMA
from gigagan_tpu_torch.train.optimizer import get_optimizer
from gigagan_tpu_torch.train.steps import TrainStepBuilder
from gigagan_tpu_torch.utils import exists

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1, item {item})"


def _promote(value, klass, **extra):
    if isinstance(value, Mapping):
        return klass(**{**dict(value), **extra})
    return value


class GigaGAN:
    def __init__(self, *, generator, discriminator=None, diff_augment=None,
                 learning_rate: float = 2e-4, betas=(0.5, 0.9),
                 weight_decay: float = 0.0,
                 discr_aux_recon_loss_weight: float = 1.0,
                 multiscale_divergence_loss_weight: float = 0.1,
                 calc_multiscale_loss_every: int = 1,
                 apply_gradient_penalty_every: int = 4,
                 create_ema_generator_at_init: bool = True,
                 log_steps_every: int = 20, amp: bool = False,
                 gp_chunk: Optional[int] = None,
                 gp_fwd_over_rev: bool = False, fused_dg_step: bool = False,
                 vision_aided_discriminator=None,
                 train_upsampler: bool = False, seed: int = 42,
                 device=None):
        if fused_dg_step:
            raise NotImplementedError(
                "fused_dg_step (one D+G program) "
                + _NOT_PORTED.format(item="2"))
        if exists(vision_aided_discriminator):
            raise NotImplementedError(
                "the vision-aided discriminator "
                + _NOT_PORTED.format(item="4, conditional path"))
        if train_upsampler:
            raise NotImplementedError(
                "training the upsampler " + _NOT_PORTED.format(item="5"))
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "GigaGAN runs on a CUDA device by default and none is "
                    'available; pass device="cpu" to run on the CPU')
            device = "cuda"
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if amp else torch.float32
        self._rng = np.random.default_rng(seed)
        init_gen = torch.Generator().manual_seed(seed)

        self.G = _promote(generator, Generator, dtype=self.dtype)
        init_parameters(self.G, init_gen)
        self.G.to(self.device)
        self.G_ema = copy.deepcopy(self.G).eval()
        self.G_ema.requires_grad_(False)

        self.D = None
        self.ema = None
        self.builder = None
        self.steps = 1
        self.log_steps_every = log_steps_every
        self.apply_gradient_penalty_every = apply_gradient_penalty_every
        self.calc_multiscale_loss_every = calc_multiscale_loss_every
        self.train_dl = None
        if not exists(discriminator):
            return

        self.D = _promote(discriminator, Discriminator, dtype=self.dtype)
        init_parameters(self.D, init_gen)
        self.D.to(self.device)
        self.g_opt = get_optimizer(self.G.parameters(), lr=learning_rate,
                                   wd=weight_decay, betas=betas)
        self.d_opt = get_optimizer(self.D.parameters(), lr=learning_rate,
                                   wd=weight_decay, betas=betas)
        self.ema = EMA(self.G_ema) if create_ema_generator_at_init else None
        self.builder = TrainStepBuilder(
            self.G, self.D, self.g_opt, self.d_opt, ema=self.ema,
            multiscale_divergence_loss_weight=(
                multiscale_divergence_loss_weight),
            discr_aux_recon_loss_weight=discr_aux_recon_loss_weight,
            diff_augment=_promote(diff_augment, DiffAugment),
            gp_chunk=gp_chunk, gp_fwd_over_rev=gp_fwd_over_rev,
        )

    # ------------------------------------------------------------ weights

    def load_jax_params(self, g_params, ema_params=None, d_params=None):
        """Load JAX parameter trees (nested mappings of arrays): the
        generator's, its EMA copy's (``g_params`` without one) and the
        discriminator's."""
        self.G.load_state_dict(convert_params(g_params, self.G))
        self.G_ema.load_state_dict(convert_params(
            g_params if ema_params is None else ema_params, self.G_ema
        ))
        if exists(d_params):
            self.D.load_state_dict(convert_params(d_params, self.D))

    # -------------------------------------------------------------- steps

    def _generators(self, seed: Optional[int]):
        """(device generator, host generator) from one seed."""
        if seed is None:
            seed = int(self._rng.integers(2 ** 63))
        s_dev, s_host = np.random.SeedSequence(seed).generate_state(2)
        return (torch.Generator(device=self.device).manual_seed(int(s_dev)),
                torch.Generator().manual_seed(int(s_host)))

    def _check_trainable(self, grad_accum_every):
        if not exists(self.builder):
            raise RuntimeError("GigaGAN was built without a discriminator")
        if grad_accum_every != 1:
            raise NotImplementedError(
                "grad_accum_every > 1 " + _NOT_PORTED.format(item="2"))

    def train_discriminator_step(self, batch, *, grad_accum_every: int = 1,
                                 apply_gradient_penalty: bool,
                                 calc_multiscale_loss: bool, draws=None,
                                 seed: Optional[int] = None) -> dict:
        """One D update on a (b, h, w, c) batch of real images in [0, 1]
        (numpy array or tensor).  ``draws`` fixes the step's random draws
        (``train.steps.StepDraws``)."""
        self._check_trainable(grad_accum_every)
        gen, host = self._generators(seed)
        return self.builder.d_step(
            torch.as_tensor(batch, device=self.device),
            apply_gp=apply_gradient_penalty,
            calc_ms=calc_multiscale_loss, draws=draws, generator=gen,
            host_generator=host,
        )

    def train_generator_step(self, batch_size: int, *,
                             grad_accum_every: int = 1,
                             calc_multiscale_loss: bool, draws=None,
                             seed: Optional[int] = None) -> dict:
        """One G update on a batch of ``batch_size`` fakes, then the EMA
        update; advances the step counter."""
        self._check_trainable(grad_accum_every)
        gen, host = self._generators(seed)
        metrics = self.builder.g_step(
            batch_size, calc_ms=calc_multiscale_loss, draws=draws,
            generator=gen, host_generator=host,
        )
        self.steps += 1
        return metrics

    def set_dataloader(self, dl):
        assert not exists(self.train_dl), (
            "training dataloader has already been set")
        self.train_dl = dl

    def train(self, steps: int, grad_accum_every: int = 1):
        """The alternating loop: a D step then a G step per iteration, R1
        on every ``apply_gradient_penalty_every``-th step, the multiscale
        losses on every ``calc_multiscale_loss_every``-th.  Returns the
        losses of each logged step as floats."""
        assert exists(self.train_dl), (
            "set the dataloader first with .set_dataloader(dl)")
        self._check_trainable(grad_accum_every)
        dl_iter = cycle(self.train_dl)
        log = []
        t0 = time.perf_counter()
        for _ in range(steps):
            step = self.steps
            apply_gp = (self.apply_gradient_penalty_every > 0
                        and step % self.apply_gradient_penalty_every == 0)
            calc_ms = (self.calc_multiscale_loss_every > 0
                       and step % self.calc_multiscale_loss_every == 0)
            d = self.train_discriminator_step(
                next(dl_iter), apply_gradient_penalty=apply_gp,
                calc_multiscale_loss=calc_ms)
            # a batch of its own for the g_step, as the JAX trainer draws
            # one; the unconditional g_step reads only its size
            g = self.train_generator_step(
                next(dl_iter).shape[0], calc_multiscale_loss=calc_ms)
            if step == 1 or step % self.log_steps_every == 0:
                record = {"step": step,
                          **{f"d_{k}": float(v) for k, v in d.items()},
                          **{f"g_{k}": float(v) for k, v in g.items()},
                          "seconds": time.perf_counter() - t0}
                log.append(record)
                print(" | ".join(f"{k}: {v:.4g}" if isinstance(v, float)
                                 else f"{k}: {v}" for k, v in record.items()))
        return log

    def __call__(self, *, steps: int, grad_accum_every: int = 1):
        return self.train(steps, grad_accum_every)

    # ----------------------------------------------------------- sampling

    @property
    def has_ema_generator(self) -> bool:
        """Whether ``G_ema`` holds an EMA generator: a trainer's when it
        keeps one (``create_ema_generator_at_init``), and a sampler's
        (built without a discriminator), whose ``G_ema`` is what
        ``load_jax_params`` loaded."""
        return exists(self.ema) or not exists(self.D)

    @torch.inference_mode()
    def generate(self, batch_size: int = 4, styles=None, noise=None,
                 seed: Optional[int] = None, use_ema: bool = True):
        """Sample from the EMA generator, or from the trained one with
        ``use_ema=False`` or when there is no EMA generator (as JAX's
        ``_generate_params``).  ``styles``/``noise`` (the style latent)
        override the drawn latent.  Returns a float32 (b, h, w, 3) numpy
        array."""
        g = self.G_ema if use_ema and self.has_ema_generator else self.G
        if seed is None:
            seed = int(self._rng.integers(2 ** 63))
        s_noise, s_latent = np.random.SeedSequence(seed).generate_state(2)
        noise_gen = torch.Generator(device=self.device).manual_seed(
            int(s_noise))
        latent_gen = torch.Generator(device=self.device).manual_seed(
            int(s_latent))
        if exists(styles):
            styles = torch.as_tensor(styles, device=self.device)
        if exists(noise):
            noise = torch.as_tensor(noise, device=self.device)
        out = g(styles=styles, noise=noise, batch_size=batch_size,
                latent_generator=latent_gen, noise_generator=noise_gen)
        return out.float().cpu().numpy()
