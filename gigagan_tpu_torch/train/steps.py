"""The unconditional discriminator and generator train steps (counterpart
of the unconditional ``d_step``/``g_step`` of gigagan_tpu/train/steps.py).

- ``d_step``: fakes from G without gradient, DiffAugment, ONE batched D
  call on [real; fake] (batch-major scale groups keep the halves
  contiguous), hinge + multiscale hinge, the R1 penalty on that same call
  via ``torch.autograd.grad(outputs=[logits, *ms], grad_outputs=[1,
  ms_w, …], create_graph=True)`` — the aux reconstruction losses stay out
  of the penalty's graph — plus the aux reconstruction loss; then the D
  optimizer step.  With ``gp_fwd_over_rev`` the penalty is taken
  forward-over-reverse instead (``_r1_fwd_over_rev``): the same value, and
  its parameter gradient from a jvp and a first-order backward in place
  of the double backward.
- ``g_step``: fakes with gradient, DiffAugment, D on the fakes, generator
  hinge + multiscale hinge; the G optimizer step, then the EMA update.

On the card the D's self-attention runs K3 forward, K4 backward and K5
inside the R1 double backward (K6a, K6b, K7a and K7b in the
forward-over-reverse surrogate instead of K5), and G's adaptive convs
K1/K2 — all through the autograd Functions of ``ops/kernels``.

Options, as in JAX:

- ``grad_accum_every``: the batch arrives as (accum, mb, h, w, c); each
  microbatch runs its losses and their backward into the ``.grad``
  buffers, its gradients and losses scaled by 1/accum (JAX's ``lax.scan``
  body), with draws of its own; then one optimizer step.  With accum = 1
  the step is the plain one.
- ``gp_chunk=c``: the reverse-over-reverse R1 penalty on the un-augmented
  pipeline over chunks of c samples (``_r1_chunked``), each chunk's share
  backpropagated before the next, so one chunk's double-backward graph is
  alive at a time: JAX's ``lax.scan(jax.checkpoint(gp_body))``.
- ``remat``: the microbatch's loss, R1 included (without a chunk), is
  recomputed in the backward (``utils.remat``), replaying the draws.

Every random draw of a step comes from explicit generators — the tensors
(latents, pixel noise, the decoder's dropout mask and patch choice) from
``generator`` on the step's device, the host-side flip decisions from the
CPU ``host_generator`` — or is given in ``StepDraws`` (one per microbatch)
so that a run can reproduce another's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import torch

from gigagan_tpu_torch import losses as L
from gigagan_tpu_torch.ops.kernels.flash_attention_hv import flash_hv_mode
from gigagan_tpu_torch.utils import exists
from gigagan_tpu_torch.utils.remat import remat


@dataclass
class StepDraws:
    """Explicit random draws of one step; a None field is drawn from the
    step's generator.  ``recon`` holds one (keep mask, patch indices) pair
    per reconstruction decoder (d_step only)."""

    latents: Optional[torch.Tensor] = None
    pixel_noise: Optional[List[torch.Tensor]] = None
    fake_flip: Optional[bool] = None
    real_flip: Optional[bool] = None
    recon: Optional[list] = None


def _micro_draws(draws, accum: int) -> list:
    """One StepDraws per microbatch."""
    if draws is None:
        return [StepDraws() for _ in range(accum)]
    if isinstance(draws, StepDraws):
        draws = [draws]
    assert len(draws) == accum, (
        f"{len(draws)} StepDraws for {accum} microbatches")
    return list(draws)


def _scaled(losses: dict, accum: int) -> dict:
    return {k: v.detach() / accum if accum > 1 else v.detach()
            for k, v in losses.items()}


class TrainStepBuilder:
    """The d/g steps of one unconditional (G, D) pair and its optimizers."""

    def __init__(self, generator, discriminator, g_opt, d_opt, *,
                 ema=None, multiscale_divergence_loss_weight: float = 0.1,
                 discr_aux_recon_loss_weight: float = 1.0,
                 diff_augment=None, gp_chunk: Optional[int] = None,
                 gp_fwd_over_rev: bool = False, remat: bool = False):
        self.G = generator
        self.D = discriminator
        self.g_opt = g_opt
        self.d_opt = d_opt
        self.ema = ema
        self.ms_w = multiscale_divergence_loss_weight
        self.aux_w = discr_aux_recon_loss_weight
        self.diff_augment = diff_augment
        self.gp_chunk = gp_chunk
        self.gp_fwd_over_rev = gp_fwd_over_rev
        self.remat = remat

    def _generate(self, batch_size, draws, generator):
        return self.G(
            batch_size=batch_size, noise=draws.latents,
            pixel_noise=draws.pixel_noise, return_all_rgbs=True,
            latent_generator=generator, noise_generator=generator,
        )

    def _augment(self, images, rgbs, flip, host_generator):
        if not exists(self.diff_augment):
            return images, rgbs
        return self.diff_augment(images, rgbs, flip=flip,
                                 generator=host_generator)

    def d_step(self, real_images, *, apply_gp: bool, calc_ms: bool,
               draws=None, generator=None, host_generator=None) -> dict:
        """One discriminator update on a (b, h, w, c) batch of reals, or on
        (accum, mb, h, w, c) microbatches.  ``draws``: a StepDraws, or one
        per microbatch.  Returns the step's losses (averaged over the
        microbatches) as 0-d tensors (no device sync)."""
        micro = real_images if real_images.dim() == 5 else real_images[None]
        accum = micro.shape[0]
        params = [p for p in self.D.parameters() if p.requires_grad]
        self.d_opt.zero_grad(set_to_none=True)
        metrics = {}
        for real, d in zip(micro, _micro_draws(draws, accum)):
            m = self._d_micro(real, d, apply_gp, calc_ms, params, accum,
                              generator, host_generator)
            metrics = {k: metrics[k] + v if k in metrics else v
                       for k, v in m.items()}
        self.d_opt.step()
        return metrics

    def _d_micro(self, real_images, draws, apply_gp, calc_ms, params, accum,
                 generator, host_generator):
        """One microbatch's losses and their backward into ``.grad``."""
        b = real_images.shape[0]
        dtype = self.D.dtype
        chunked = apply_gp and exists(self.gp_chunk)

        with torch.no_grad():
            fake, fake_rgbs = self._generate(b, draws, generator)
        fake_aug, fake_rgbs_aug = self._augment(fake, fake_rgbs,
                                                draws.fake_flip,
                                                host_generator)

        real = real_images.to(dtype)
        fake_aug = fake_aug.to(dtype)
        if apply_gp and not chunked:
            real = real.detach().requires_grad_()
            fake_aug = fake_aug.detach().requires_grad_()
        real_flip = draws.real_flip
        if real_flip is None and exists(self.diff_augment):
            real_flip = self.diff_augment.draw(host_generator)

        def pair_inputs(real_, fake_):
            """[real; fake] and its rgbs, paired per resolution, for ONE
            batched D call."""
            real_aug, real_rgbs = self._augment(
                real_, self.D.real_images_to_rgbs(real_), real_flip, None)
            by_res = [{t.shape[1]: t for t in lst}
                      for lst in (real_rgbs, fake_rgbs_aug)]
            pair_rgbs = [torch.cat([ix[r].to(dtype) for ix in by_res])
                         for r in self.D.multiscale_input_resolutions]
            return torch.cat((real_aug, fake_)), pair_rgbs

        def loss(real, fake_aug):
            logits, ms, aux_losses = self.D(
                *pair_inputs(real, fake_aug),
                return_multiscale_outputs=calc_ms, calc_aux_loss=True,
                aux_recon_samples=b, recon_draws=draws.recon,
                generator=generator,
            )

            divergence = L.discriminator_hinge_loss(logits[:, :b],
                                                    logits[:, b:])
            total = divergence
            ms_div = torch.zeros((), device=logits.device)
            if self.ms_w > 0.0 and calc_ms and ms:
                for m in ms:
                    half = m.shape[0] // 2
                    ms_div = ms_div + L.discriminator_hinge_loss(m[:half],
                                                                 m[half:])
                total = total + ms_div * self.ms_w

            gp = torch.zeros((), device=logits.device)
            if apply_gp and not chunked:
                # R1 on the same call; aux losses are outside its graph
                outputs = [logits, *ms]
                cots = [torch.ones_like(logits),
                        *[torch.ones_like(m) * self.ms_w for m in ms]]
                g_real, g_fake = torch.autograd.grad(
                    outputs, [real, fake_aug], cots,
                    create_graph=not self.gp_fwd_over_rev,
                    retain_graph=True)
                gp = 10.0 * (L.sample_sq_norms(g_real).mean()
                             + L.sample_sq_norms(g_fake).mean())
                if self.gp_fwd_over_rev:
                    gp = gp + self._r1_fwd_over_rev(
                        pair_inputs, real, fake_aug, g_real, g_fake, calc_ms)
                total = total + gp

            aux = torch.zeros((), device=logits.device)
            if self.aux_w > 0.0 and aux_losses:
                aux = sum(aux_losses)
                total = total + aux * self.aux_w
            return total, dict(divergence=divergence,
                               multiscale_divergence=ms_div,
                               gradient_penalty=gp, aux_reconstruction=aux)

        if self.remat:
            total, metrics = remat(loss, real, fake_aug,
                                   generators=(generator,))
        else:
            total, metrics = loss(real, fake_aug)
        if accum > 1:
            total = total / accum
        total.backward(inputs=params)
        if chunked:
            metrics["gradient_penalty"] = self._r1_chunked(
                real, fake, fake_rgbs, calc_ms, params, accum)
        return _scaled(metrics, accum)

    def _r1_chunked(self, real, fake, fake_rgbs, calc_ms, params, accum):
        """The R1 penalty 10·Σ‖∇‖²/b over chunks of ``gp_chunk`` samples,
        each chunk's share backpropagated into ``.grad`` at once; returns
        its value.  As JAX's chunked penalty it runs on the un-augmented
        pipeline (the reals and the fakes before DiffAugment): D is per
        sample, so it equals the unchunked penalty of an unflipped step.
        A chunk is one D call on its 2c images, without the aux losses."""
        b = real.shape[0]
        c = min(self.gp_chunk, b)
        assert b % c == 0, f"gp_chunk {c} must divide microbatch {b}"
        dtype = self.D.dtype
        total_sq = torch.zeros((), device=real.device)
        for i in range(0, b, c):
            r = real[i:i + c].detach().requires_grad_()
            f = fake[i:i + c].to(dtype).detach().requires_grad_()
            by_res = [{t.shape[1]: t for t in lst}
                      for lst in (self.D.real_images_to_rgbs(r),
                                  [t[i:i + c] for t in fake_rgbs])]
            rgbs = [torch.cat([ix[res].to(dtype) for ix in by_res])
                    for res in self.D.multiscale_input_resolutions]
            logits, ms, _ = self.D(torch.cat((r, f)), rgbs,
                                   return_multiscale_outputs=calc_ms,
                                   calc_aux_loss=False)
            cots = [torch.ones_like(logits),
                    *[torch.ones_like(m) * self.ms_w for m in ms]]
            g_r, g_f = torch.autograd.grad([logits, *ms], [r, f], cots,
                                           create_graph=True)
            sq = L.sample_sq_norms(g_r).sum() + L.sample_sq_norms(g_f).sum()
            (sq * (10.0 / (b * accum))).backward(inputs=params)
            total_sq = total_sq + sq.detach()
        return 10.0 * total_sq / b

    def _r1_fwd_over_rev(self, pair_inputs, real, fake, v_real, v_fake,
                         calc_ms):
        """The parameter gradient of the R1 penalty, as a surrogate whose
        value is 0 (gigagan_tpu/train/steps.py, ``gp_fwd_over_rev``).

        v = ∇ₓ⟨D(x), u⟩ is the penalty's input gradient, taken at frozen
        parameters (no ``create_graph``).  ∇θ 10·mean‖v‖² = ∇θ (20/b)·⟨v(θ),
        sg(v)⟩, and ⟨v(θ), sg(v)⟩ is the directional derivative of
        φ(x) = ⟨D(x), u⟩ along sg(v): one jvp of φ, then a first-order
        backward.  φ is the step's own D pipeline — the same real-side flip,
        the fakes' rgbs as constants, the aux losses out — with the
        attention on the grad-of-jvp kernels (``flash_hv_mode``)."""

        def phi(r, f):
            with flash_hv_mode():
                lg, msl, _ = self.D(*pair_inputs(r, f),
                                    return_multiscale_outputs=calc_ms,
                                    calc_aux_loss=False)
            out = lg.float().sum()
            for m in msl:
                out = out + self.ms_w * m.float().sum()
            return out

        _, s = torch.func.jvp(phi, (real.detach(), fake.detach()),
                              (v_real.to(real.dtype),
                               v_fake.to(fake.dtype)))
        surrogate = (20.0 / real.shape[0]) * s
        return surrogate - surrogate.detach()

    def g_step(self, batch_size: int, *, calc_ms: bool,
               grad_accum_every: int = 1, draws=None, generator=None,
               host_generator=None) -> dict:
        """One generator update on ``grad_accum_every`` microbatches of
        ``batch_size`` fakes (and the EMA update after it)."""
        params = [p for p in self.G.parameters() if p.requires_grad]
        self.g_opt.zero_grad(set_to_none=True)
        metrics = {}
        for d in _micro_draws(draws, grad_accum_every):
            loss = functools.partial(self._g_loss, batch_size, d, calc_ms,
                                     generator, host_generator)
            if self.remat:
                total, m = remat(loss,
                                 generators=(generator, host_generator))
            else:
                total, m = loss()
            if grad_accum_every > 1:
                total = total / grad_accum_every
            total.backward(inputs=params)
            m = _scaled(m, grad_accum_every)
            metrics = {k: metrics[k] + v if k in metrics else v
                       for k, v in m.items()}
        self.g_opt.step()
        if exists(self.ema):
            self.ema.update(self.G)
        return metrics

    def _g_loss(self, batch_size, draws, calc_ms, generator, host_generator):
        """One microbatch's generator losses: (total, losses)."""
        fake, rgbs = self._generate(batch_size, draws, generator)
        fake_aug, rgbs_aug = self._augment(fake, rgbs, draws.fake_flip,
                                           host_generator)
        dtype = self.D.dtype
        logits, ms, _ = self.D(
            fake_aug.to(dtype), [r.to(dtype) for r in rgbs_aug],
            return_multiscale_outputs=calc_ms, calc_aux_loss=False,
        )
        divergence = L.generator_hinge_loss(logits)
        total = divergence
        ms_div = torch.zeros((), device=logits.device)
        if self.ms_w > 0.0 and calc_ms and ms:
            for m in ms:
                ms_div = ms_div + L.generator_hinge_loss(m)
            total = total + ms_div * self.ms_w
        return total, dict(divergence=divergence,
                           multiscale_divergence=ms_div)
