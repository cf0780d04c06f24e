"""The discriminator and generator train steps (counterpart of
``d_step``/``g_step`` of gigagan_tpu/train/steps.py).

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

Text-conditioned (a conditional G and D, CLIP token encodings and
embeddings per sample), as in JAX:

- matching-aware loss: D must reject (image, text) pairs whose text is the
  previous sample's — rolled over the whole accumulated set (the JAX
  package's fix of reference defect #2: a roll within a microbatch of one
  is the identity).  On steps without an unchunked R1 these rows ride in
  the main D call, as [real_aug; fake_aug; real; fake] with texts [t; t;
  rolled; rolled]; with it, a separate D call takes them, so that the
  penalty's backward does not run through them.
- vision-aided D (``vision_aided_discriminator`` with a ``clip``): a hinge
  on CLIP's visual taps of the reals and the augmented fakes, its own
  optimizer, and with R1 a penalty on the gradient to the real taps, per
  sample over the (L, b, n, d) stack (JAX's documented divergence from the
  reference, which takes the layer axis as the batch); in the g_step, the
  generator hinge of the VD on the augmented fakes.
- CLIP contrastive loss in the g_step over the whole accumulated pool:
  with accumulation, a forward-only pass first embeds every microbatch's
  fakes (the same draws as its step), the pooled InfoNCE and its gradient
  to the embeds are taken once, and each microbatch's loss carries the
  surrogate ⟨eᵢ, sg(∂L/∂eᵢ)⟩, whose parameter gradient is the pooled
  loss's.

On the card the D's self-attention runs K3 forward, K4 backward and K5
inside the R1 double backward (K6a, K6b, K7a and K7b in the
forward-over-reverse surrogate instead of K5), and G's adaptive convs
K1/K2 — all through the autograd Functions of ``ops/kernels``.

Training the upsampler (``train_upsampler``), as in JAX: G is the
``UnetUpsampler``, fed the reals resized to its input size by 'nearest'
(torch's default ``F.interpolate`` mode, as the reference does), so the
g_step takes the real batch as the d_step does; D reads the rgbs of G's
``return_all_rgbs`` at its multiscale resolutions.

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

Inside the forward-over-reverse surrogate φ the adaptive convs (the
conditional predictors') take their unfused conv (``ops.adaptive_conv``
under ``flash_hv_mode``), as JAX runs them on its XLA conv there: K1's
autograd Function has no jvp.

Every random draw of a step comes from explicit generators — the tensors
(latents, pixel noise, the decoder's dropout mask and patch choice) from
``generator`` on the step's device, the host-side flip decisions from the
CPU ``host_generator`` — or is given in ``StepDraws`` (one per microbatch)
so that a run can reproduce another's.

Data parallel (inside a ``torch.distributed`` process group, see
``parallel/dist.py``): each rank takes its slice of every microbatch of
the global batch and draws the global batch's latents, pixel noise and
reconstruction draws from the shared generators, keeping its slice
(``dist.batch_draws``); the host flips advance alike on every rank.
The matching-aware roll spans the global accumulated set (the text
encodings gathered without gradient), the contrastive loss the global
pool (``losses.all_gather_batch``; with accumulation the pooled gradient's
slice of this rank, times the world size); the gradients and the reported
losses are averaged over the ranks before each optimizer step.  A step of
k ranks then equals one process's step at the global batch, up to the
order of the reductions.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import torch

from gigagan_tpu_torch import losses as L
from gigagan_tpu_torch import ops
from gigagan_tpu_torch.ops.kernels.flash_attention_hv import flash_hv_mode
from gigagan_tpu_torch.parallel import dist
from gigagan_tpu_torch.utils import exists, span
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


def _stack(t, accumulated: bool):
    """A per-microbatch view of an optional batch tensor: (accum, mb, ...)
    as it is, or (mb, ...) as one microbatch."""
    if t is None:
        return None
    return t if accumulated else t[None]


def _states(*generators):
    return [g.get_state() if g is not None else None for g in generators]


def _set_states(generators, states):
    for g, state in zip(generators, states):
        if g is not None:
            g.set_state(state)


def _scaled(losses: dict, accum: int) -> dict:
    return {k: v.detach() / accum if accum > 1 else v.detach()
            for k, v in losses.items()}


def _averaged_over_ranks(params, metrics: dict) -> dict:
    """Average the parameters' gradients and the losses over the ranks of
    the process group (without one, nothing to do)."""
    if not dist.is_initialized():
        return metrics
    dist.all_reduce_mean_([p.grad for p in params])
    keys = list(metrics)
    values = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce_mean_([values])
    return dict(zip(keys, values.unbind()))


class TrainStepBuilder:
    """The d/g steps of one (G, D[, VD]) trio and its optimizers."""

    def __init__(self, generator, discriminator, g_opt, d_opt, *,
                 ema=None, vision_aided_discriminator=None, vd_opt=None,
                 clip=None, multiscale_divergence_loss_weight: float = 0.1,
                 discr_aux_recon_loss_weight: float = 1.0,
                 vision_aided_divergence_loss_weight: float = 0.5,
                 generator_contrastive_loss_weight: float = 0.1,
                 matching_awareness_loss_weight: float = 0.1,
                 diff_augment=None, gp_chunk: Optional[int] = None,
                 gp_fwd_over_rev: bool = False, remat: bool = False,
                 train_upsampler: bool = False,
                 input_image_size: Optional[int] = None):
        self.G = generator
        self.D = discriminator
        self.VD = vision_aided_discriminator
        self.clip = clip
        self.g_opt = g_opt
        self.d_opt = d_opt
        self.vd_opt = vd_opt
        self.ema = ema
        self.ms_w = multiscale_divergence_loss_weight
        self.aux_w = discr_aux_recon_loss_weight
        self.vd_w = vision_aided_divergence_loss_weight
        self.contrastive_w = generator_contrastive_loss_weight
        self.matching_w = matching_awareness_loss_weight
        self.diff_augment = diff_augment
        self.gp_chunk = gp_chunk
        self.gp_fwd_over_rev = gp_fwd_over_rev
        self.remat = remat
        self.train_upsampler = train_upsampler
        self.input_image_size = input_image_size
        assert not train_upsampler or exists(input_image_size), (
            "training the upsampler needs its input_image_size")

    @property
    def unconditional(self):
        return self.D.unconditional

    @property
    def need_vd(self):
        return exists(self.VD) and self.vd_w > 0.0 and exists(self.clip)

    @property
    def need_contrastive(self):
        return (self.contrastive_w > 0.0 and not self.unconditional
                and exists(self.clip))

    @property
    def want_matching(self):
        return not self.unconditional and self.matching_w > 0.0

    def _generate(self, batch_size, draws, generator, text=None, real=None):
        """G's output and rgbs for ``batch_size`` fakes; the upsampler's
        from the reals resized to its input size."""
        if self.train_upsampler:
            with span("gigagan.up.lowres"):
                lowres = ops.resize_image_to(real, self.input_image_size,
                                             "nearest")
            return self.G(lowres, noise=draws.latents, text_encodings=text,
                          return_all_rgbs=True, latent_generator=generator)
        return self.G(
            batch_size=batch_size, noise=draws.latents,
            pixel_noise=draws.pixel_noise, text_encodings=text,
            return_all_rgbs=True, latent_generator=generator,
            noise_generator=generator,
        )

    def _augment(self, images, rgbs, flip, host_generator):
        if not exists(self.diff_augment):
            return images, rgbs
        return self.diff_augment(images, rgbs, flip=flip,
                                 generator=host_generator)

    def d_step(self, real_images, *, text_encodings=None, text_embeds=None,
               apply_gp: bool, calc_ms: bool, draws=None, generator=None,
               host_generator=None) -> dict:
        """One discriminator (and vision-aided D) update on a (b, h, w, c)
        batch of reals, or on (accum, mb, h, w, c) microbatches; with text
        conditioning the CLIP ``text_encodings`` (b, n, d) and
        ``text_embeds`` (b, e) of the same samples (with the accum axis
        too when the reals have it).  ``draws``: a StepDraws, or one per
        microbatch.  Returns the step's losses (averaged over the
        microbatches) as 0-d tensors (no device sync)."""
        accumulated = real_images.dim() == 5
        micro = _stack(real_images, accumulated)
        accum, mb = micro.shape[:2]
        texts = _stack(text_encodings, accumulated)
        embeds = _stack(text_embeds, accumulated)
        assert self.unconditional or exists(texts), (
            "text encodings must be passed in for conditional training")
        rank, world = dist.rank(), dist.world_size()
        rolled = None
        if self.want_matching:
            assert accum * mb * world >= 2, (
                "matching-aware loss needs a total accumulated batch of ≥2 "
                f"samples (got grad_accum={accum} × microbatch={mb} × "
                f"{world} ranks); a 1-sample roll is the identity and would "
                "punish D for accepting correctly matched pairs")
            # rolled over the global set, microbatch-major: rank r's first
            # rolled text is rank r-1's last
            every = dist.all_gather_cat(texts).reshape(world, *texts.shape)
            rolled = torch.roll(
                every.transpose(0, 1).reshape(-1, *texts.shape[2:]), 1, 0
            ).reshape(accum, world, *texts.shape[1:])[:, rank]
        params = [p for p in self.D.parameters() if p.requires_grad]
        opts = [self.d_opt]
        if self.need_vd:
            params += [p for p in self.VD.parameters() if p.requires_grad]
            opts.append(self.vd_opt)
        with span("gigagan.d.optimizer"):
            for opt in opts:
                opt.zero_grad(set_to_none=True)
        metrics = {}
        with dist.batch_draws():
            for i, d in enumerate(_micro_draws(draws, accum)):
                m = self._d_micro(
                    micro[i], texts[i] if exists(texts) else None,
                    embeds[i] if exists(embeds) else None,
                    rolled[i] if exists(rolled) else None, d, apply_gp,
                    calc_ms, params, accum, generator, host_generator)
                metrics = {k: metrics[k] + v if k in metrics else v
                           for k, v in m.items()}
        metrics = _averaged_over_ranks(params, metrics)
        with span("gigagan.d.optimizer"):
            for opt in opts:
                opt.step()
        return metrics

    def _d_micro(self, real_images, text, embeds, rolled, draws, apply_gp,
                 calc_ms, params, accum, generator, host_generator):
        """One microbatch's losses and their backward into ``.grad``."""
        b = real_images.shape[0]
        dtype = self.D.dtype
        chunked = apply_gp and exists(self.gp_chunk)
        # the matching rows ride in the main D call unless an unchunked R1
        # differentiates it
        fold = self.want_matching and not (apply_gp and not chunked)

        with span("gigagan.d.fakes"), torch.no_grad():
            fake, fake_rgbs = self._generate(b, draws, generator, text,
                                             real_images)
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
            """[real; fake] (and, folded in, the matching rows [real;
            fake] un-augmented), their rgbs paired per resolution and their
            texts, for ONE batched D call."""
            real_aug, real_rgbs = self._augment(
                real_, self.D.real_images_to_rgbs(real_), real_flip, None)
            by_res = [{t.shape[1]: t for t in lst}
                      for lst in (real_rgbs, fake_rgbs_aug)]
            rgbs = [torch.cat([ix[r].to(dtype) for ix in by_res])
                    for r in self.D.multiscale_input_resolutions]
            images = torch.cat((real_aug, fake_))
            texts = None if self.unconditional else torch.cat((text, text))
            if fold:
                m_images, m_rgbs, m_texts = self._matching_inputs(
                    real_, fake, fake_rgbs, rolled)
                images = torch.cat((images, m_images))
                rgbs = [torch.cat(pair) for pair in zip(rgbs, m_rgbs)]
                texts = torch.cat((texts, m_texts))
            return images, rgbs, texts

        def loss(real, fake_aug):
            logits, ms, aux_losses = self.D(
                *pair_inputs(real, fake_aug),
                return_multiscale_outputs=calc_ms, calc_aux_loss=True,
                aux_recon_samples=b, recon_draws=draws.recon,
                generator=generator,
            )
            zero = torch.zeros((), device=logits.device)
            matching = zero
            if fold:
                # the matching columns off before the hinge halves
                m_logits, logits = logits[:, 2 * b:], logits[:, :2 * b]
                ms = [m[:2 * (m.shape[0] // 4)] for m in ms]
                matching = L.aux_matching_loss(m_logits[:, :b],
                                               m_logits[:, b:])

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

            vd_div = zero
            if self.need_vd:
                vd_div, vd_gp = self._vd_d_terms(real_images.to(dtype),
                                                 fake_aug, embeds, apply_gp)
                total = total + vd_div * self.vd_w
                if apply_gp:
                    total = total + vd_gp
                    gp = gp + vd_gp

            if self.want_matching and not fold:
                m_logits, _, _ = self.D(
                    *self._matching_inputs(real_images.to(dtype), fake,
                                           fake_rgbs, rolled),
                    return_multiscale_outputs=False, calc_aux_loss=False)
                matching = L.aux_matching_loss(m_logits[:, :b],
                                               m_logits[:, b:])
            if self.want_matching:
                total = total + matching * self.matching_w
            return total, dict(divergence=divergence,
                               multiscale_divergence=ms_div,
                               vision_aided_divergence=vd_div,
                               matching_aware_loss=matching,
                               gradient_penalty=gp, aux_reconstruction=aux)

        with span("gigagan.d.loss"):
            if self.remat:
                total, metrics = remat(loss, real, fake_aug,
                                       generators=(generator,))
            else:
                total, metrics = loss(real, fake_aug)
            if accum > 1:
                total = total / accum
        with span("gigagan.d.backward"):
            total.backward(inputs=params)
        if chunked:
            with span("gigagan.d.r1_chunked"):
                metrics["gradient_penalty"] = metrics["gradient_penalty"] \
                    + self._r1_chunked(real, fake, fake_rgbs, text, calc_ms,
                                       params, accum)
        return _scaled(metrics, accum)

    def _matching_inputs(self, real, fake, fake_rgbs, rolled):
        """The matching-aware rows: [real; fake] un-augmented, their rgbs
        paired per resolution and the rolled texts (folded into the main
        D call, or a call of their own on an unchunked R1 step)."""
        by_res = [{t.shape[1]: t for t in lst}
                  for lst in (self.D.real_images_to_rgbs(real), fake_rgbs)]
        rgbs = [torch.cat([ix[r].to(real.dtype) for ix in by_res])
                for r in self.D.multiscale_input_resolutions]
        return (torch.cat((real, fake.to(real.dtype))), rgbs,
                torch.cat((rolled, rolled)))

    def _vd_d_terms(self, real, fake_aug, embeds, apply_gp):
        """The vision-aided D's hinge on the CLIP taps of the reals and the
        augmented fakes, and with ``apply_gp`` its penalty: 10·mean over
        samples of ‖∂(vd_w·Σ real logits)/∂taps‖² (each sample's slice of
        the (L, b, n, d) taps)."""
        with torch.no_grad():
            real_taps = self.clip.embed_images(real)[1]
            fake_taps = self.clip.embed_images(fake_aug)[1]
        real_taps.requires_grad_(apply_gp)
        real_logits = self.VD(real_taps, embeds)
        fake_logits = self.VD(fake_taps, embeds)
        vd_div = sum(L.discriminator_hinge_loss(r, f)
                     for r, f in zip(real_logits, fake_logits))
        vd_gp = None
        if apply_gp:
            (g,) = torch.autograd.grad(
                real_logits, real_taps,
                [torch.ones_like(t) * self.vd_w for t in real_logits],
                create_graph=True)
            vd_gp = 10.0 * L.sample_sq_norms(g.movedim(1, 0)).mean()
        return vd_div, vd_gp

    def _r1_chunked(self, real, fake, fake_rgbs, text, calc_ms, params,
                    accum):
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
            t = (None if self.unconditional else
                 torch.cat((text[i:i + c], text[i:i + c])))
            logits, ms, _ = self.D(torch.cat((r, f)), rgbs, t,
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

    def g_step(self, batch, *, text_encodings=None, text_embeds=None,
               calc_ms: bool, grad_accum_every: int = 1, draws=None,
               generator=None, host_generator=None) -> dict:
        """One generator update on ``grad_accum_every`` microbatches (and
        the EMA update after it).  ``batch``: the microbatch size (an int),
        or the real batch, (mb, h, w, c) or (accum, mb, h, w, c), whose
        size it takes; training the upsampler, the reals, whose low-res
        copies G upsamples.  With text conditioning the fakes' CLIP
        ``text_encodings`` (mb, n, d) and ``text_embeds`` (mb, e), or
        (accum, mb, ...)."""
        accum = grad_accum_every
        reals = None
        if isinstance(batch, int):
            batch_size = batch
        else:
            reals = _stack(batch, batch.dim() == 5)
            assert reals.shape[0] == accum, (
                f"batch leading dim {reals.shape[0]} != grad_accum {accum}")
            batch_size = reals.shape[1]
        assert not self.train_upsampler or exists(reals), (
            "the upsampler's g_step needs the real batch")
        accumulated = exists(text_encodings) and text_encodings.dim() == 4
        texts = _stack(text_encodings, accumulated)
        embeds = _stack(text_embeds, accumulated)
        assert self.unconditional or exists(texts), (
            "text encodings must be passed in for conditional training")
        micro = _micro_draws(draws, accum)
        gens = (generator, host_generator)
        with dist.batch_draws():
            metrics = self._g_micros(batch_size, texts, embeds, reals,
                                     micro, gens, calc_ms, accum)
        params = [p for p in self.G.parameters() if p.requires_grad]
        metrics = _averaged_over_ranks(params, metrics)
        with span("gigagan.g.optimizer"):
            self.g_opt.step()
        if exists(self.ema):
            with span("gigagan.g.ema"):
                self.ema.update(self.G)
        return metrics

    def _g_micros(self, batch_size, texts, embeds, reals, micro, gens,
                  calc_ms, accum):
        """Every microbatch's generator losses and their backward into
        ``.grad``; the losses averaged over the microbatches."""
        generator, host_generator = gens
        pool, states = [(None, None)] * accum, None
        if self.need_contrastive:
            assert accum * embeds.shape[1] * dist.world_size() >= 2, (
                "CLIP contrastive loss needs a total accumulated batch of "
                f"≥2 samples (got grad_accum={accum} × microbatch="
                f"{embeds.shape[1]} × {dist.world_size()} ranks); a 1-pair "
                "pool is identically 0 with zero gradient")
            if accum > 1:
                with span("gigagan.g.loss"):
                    pool, states = self._contrastive_pool(
                        batch_size, texts, embeds, micro, gens, reals)
        params = [p for p in self.G.parameters() if p.requires_grad]
        with span("gigagan.g.optimizer"):
            self.g_opt.zero_grad(set_to_none=True)
        metrics = {}
        for i, d in enumerate(micro):
            if exists(states):  # the draws of this microbatch's pool pass
                _set_states(gens, states[i])
            loss = functools.partial(
                self._g_loss, batch_size, d, calc_ms, generator,
                host_generator, texts[i] if exists(texts) else None,
                embeds[i] if exists(embeds) else None, *pool[i], accum,
                reals[i] if exists(reals) else None)
            with span("gigagan.g.loss"):
                if self.remat:
                    total, m = remat(loss,
                                     generators=(generator, host_generator))
                else:
                    total, m = loss()
                if accum > 1:
                    total = total / accum
            with span("gigagan.g.backward"):
                total.backward(inputs=params)
            m = _scaled(m, accum)
            metrics = {k: metrics[k] + v if k in metrics else v
                       for k, v in m.items()}
        return metrics

    def _contrastive_pool(self, batch_size, texts, embeds, micro, gens,
                          reals=None):
        """The pooled InfoNCE over every microbatch's augmented fakes (of
        every rank), from a forward-only pass with each microbatch's draws:
        per microbatch (∂L/∂eᵢ, L), and the generators' states at each
        microbatch's start, so that its step draws the same fakes again.
        A rank's slice of ∂L/∂e is its share of the gradient; the ranks'
        gradients are averaged, so it is scaled by the world size."""
        states, image_embeds = [], []
        with torch.no_grad():
            for i, d in enumerate(micro):
                states.append(_states(*gens))
                fake, rgbs = self._generate(
                    batch_size, d, gens[0], texts[i],
                    reals[i] if exists(reals) else None)
                fake_aug, _ = self._augment(fake, rgbs, d.fake_flip, gens[1])
                image_embeds.append(self.clip.embed_images(fake_aug)[0])
        mine = torch.cat(image_embeds)
        e = dist.all_gather_cat(mine).requires_grad_()
        value = L.clip_contrastive_loss(
            e, dist.all_gather_cat(
                embeds.reshape(mine.shape[0], -1).float()),
            self.clip.logit_scale)
        (grad,) = torch.autograd.grad(value, e)
        rank, world = dist.rank(), dist.world_size()
        grad = grad[rank * mine.shape[0]:(rank + 1) * mine.shape[0]] * world
        return ([(g, value.detach()) for g in grad.split(batch_size)],
                states)

    def _g_loss(self, batch_size, draws, calc_ms, generator, host_generator,
                text=None, embeds=None, pool_grad=None, pool_value=None,
                accum=1, real=None):
        """One microbatch's generator losses: (total, losses)."""
        fake, rgbs = self._generate(batch_size, draws, generator, text, real)
        fake_aug, rgbs_aug = self._augment(fake, rgbs, draws.fake_flip,
                                           host_generator)
        dtype = self.D.dtype
        logits, ms, _ = self.D(
            fake_aug.to(dtype), [r.to(dtype) for r in rgbs_aug], text,
            return_multiscale_outputs=calc_ms, calc_aux_loss=False,
        )
        divergence = L.generator_hinge_loss(logits)
        total = divergence
        zero = torch.zeros((), device=logits.device)
        ms_div = zero
        if self.ms_w > 0.0 and calc_ms and ms:
            for m in ms:
                ms_div = ms_div + L.generator_hinge_loss(m)
            total = total + ms_div * self.ms_w

        vd_div = contrastive = zero
        if self.need_vd or self.need_contrastive:
            image_embeds, taps = self.clip.embed_images(fake_aug)
        if self.need_vd:
            vd_div = sum(L.generator_hinge_loss(t)
                         for t in self.VD(taps, embeds))
            total = total + vd_div * self.vd_w
        if self.need_contrastive:
            if exists(pool_grad):
                # the pooled loss's value; this microbatch's share of its
                # gradient through the linear surrogate (accum undoes the
                # step's 1/accum)
                sur = accum * (image_embeds * pool_grad).sum()
                contrastive = pool_value + sur - sur.detach()
            else:  # over the global batch inside a process group
                contrastive = L.clip_contrastive_loss(
                    L.all_gather_batch(image_embeds),
                    dist.all_gather_cat(embeds), self.clip.logit_scale)
            total = total + contrastive * self.contrastive_w
        return total, dict(divergence=divergence,
                           multiscale_divergence=ms_div,
                           total_vd_divergence=vd_div,
                           contrastive_loss=contrastive)
