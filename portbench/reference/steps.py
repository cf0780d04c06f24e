"""The reference's train steps: a frozen copy of the port's ``d_step`` and
``g_step`` (``gigagan_tpu_torch/train/steps.py``) for one process, one
microbatch and the reverse-over-reverse R1, without the options the
benchmark's cells do not take (accumulation, chunked or recomputed R1,
forward-over-reverse, data parallel, the upsampler).

- ``d_step``: fakes from G without gradient, DiffAugment, one batched D
  call on [real; fake] (the matching-aware rows folded in unless an R1
  differentiates the call), hinge + multiscale hinge, the R1 penalty by a
  double backward, the aux reconstruction loss, the vision-aided D's hinge
  and penalty, the matching-aware loss; then the D (and VD) Adam steps.
- ``g_step``: fakes with gradient, DiffAugment, D on the fakes, generator
  hinge + multiscale hinge, the VD's generator hinge, the CLIP
  contrastive loss; the G Adam step, then the EMA update.

Every draw comes from the step's two generators in the port's order."""

from __future__ import annotations

import torch

from portbench.reference import losses as L
from portbench.reference.utils import exists


class TrainSteps:
    """The d/g steps of one (G, D[, VD]) trio and its optimizers."""

    def __init__(self, G, D, g_opt, d_opt, *, ema=None, VD=None, vd_opt=None,
                 clip=None, diff_augment=None, weights):
        self.G, self.D, self.VD, self.clip = G, D, VD, clip
        self.g_opt, self.d_opt, self.vd_opt = g_opt, d_opt, vd_opt
        self.ema = ema
        self.diff_augment = diff_augment
        self.ms_w = weights["multiscale_divergence_loss_weight"]
        self.aux_w = weights["discr_aux_recon_loss_weight"]
        self.vd_w = weights["vision_aided_divergence_loss_weight"]
        self.contrastive_w = weights["generator_contrastive_loss_weight"]
        self.matching_w = weights["matching_awareness_loss_weight"]

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

    def _generate(self, batch_size, generator, text=None):
        return self.G(batch_size=batch_size, text_encodings=text,
                      return_all_rgbs=True, latent_generator=generator,
                      noise_generator=generator)

    def _augment(self, images, rgbs, flip, host_generator):
        if not exists(self.diff_augment):
            return images, rgbs
        return self.diff_augment(images, rgbs, flip=flip,
                                 generator=host_generator)

    def _matching_inputs(self, real, fake, fake_rgbs, rolled):
        by_res = [{t.shape[1]: t for t in lst}
                  for lst in (self.D.real_images_to_rgbs(real), fake_rgbs)]
        rgbs = [torch.cat([ix[r] for ix in by_res])
                for r in self.D.multiscale_input_resolutions]
        return torch.cat((real, fake)), rgbs, torch.cat((rolled, rolled))

    def d_step(self, real_images, *, text_encodings=None, text_embeds=None,
               apply_gp: bool, calc_ms: bool, generator, host_generator,
               rows=None):
        """One D (and VD) update on reals (b, h, w, c); returns its
        losses.  ``rows`` < b takes the losses and their backward in blocks
        of that many samples (every D loss is a mean over samples; the
        matching-aware texts are rolled over the whole batch), the step's
        draws made for the whole batch first, in the order one call makes
        them."""
        b = real_images.shape[0]
        rows = min(rows or b, b)
        assert b % rows == 0, f"{rows} rows do not divide the batch {b}"
        text, embeds = text_encodings, text_embeds
        rolled = (torch.roll(text, 1, 0) if self.want_matching else None)
        params = [p for p in self.D.parameters() if p.requires_grad]
        opts = [self.d_opt]
        if self.need_vd:
            params += [p for p in self.VD.parameters() if p.requires_grad]
            opts.append(self.vd_opt)
        for opt in opts:
            opt.zero_grad(set_to_none=True)

        with torch.no_grad():
            fake, fake_rgbs = self._generate(b, generator, text)
        fake_aug, fake_rgbs_aug = self._augment(fake, fake_rgbs, None,
                                                host_generator)
        real_flip = (self.diff_augment.draw(host_generator)
                     if exists(self.diff_augment) else None)
        recon = (self.D.draw_recon(b, generator, real_images.device)
                 if rows < b else None)
        metrics = {}
        for i in range(0, b, rows):
            block = slice(i, i + rows)
            total, m = self._d_losses(
                real_images[block], fake[block],
                [t[block] for t in fake_rgbs], fake_aug[block],
                [t[block] for t in fake_rgbs_aug], real_flip,
                *(None if t is None else t[block]
                  for t in (text, embeds, rolled)), apply_gp, calc_ms,
                generator,
                None if recon is None else [
                    (None if k is None else k[block],
                     None if j is None else j[block]) for k, j in recon])
            (total * (rows / b)).backward(inputs=params)
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach() * (rows / b)
        for opt in opts:
            opt.step()
        return metrics

    def _d_losses(self, real_images, fake, fake_rgbs, fake_aug,
                  fake_rgbs_aug, real_flip, text, embeds, rolled, apply_gp,
                  calc_ms, generator, recon_draws):
        """The D losses of one block of samples: (total, losses)."""
        b = real_images.shape[0]
        fold = self.want_matching and not apply_gp
        real = real_images
        if apply_gp:
            real = real.detach().requires_grad_()
            fake_aug = fake_aug.detach().requires_grad_()

        real_aug, real_rgbs = self._augment(
            real, self.D.real_images_to_rgbs(real), real_flip, None)
        by_res = [{t.shape[1]: t for t in lst}
                  for lst in (real_rgbs, fake_rgbs_aug)]
        rgbs = [torch.cat([ix[r] for ix in by_res])
                for r in self.D.multiscale_input_resolutions]
        images = torch.cat((real_aug, fake_aug))
        texts = None if self.unconditional else torch.cat((text, text))
        if fold:
            m_images, m_rgbs, m_texts = self._matching_inputs(
                real, fake, fake_rgbs, rolled)
            images = torch.cat((images, m_images))
            rgbs = [torch.cat(pair) for pair in zip(rgbs, m_rgbs)]
            texts = torch.cat((texts, m_texts))

        logits, ms, aux_losses = self.D(
            images, rgbs, texts, return_multiscale_outputs=calc_ms,
            calc_aux_loss=True, aux_recon_samples=b,
            recon_draws=recon_draws, generator=generator)
        zero = torch.zeros((), device=logits.device)
        matching = zero
        if fold:
            m_logits, logits = logits[:, 2 * b:], logits[:, :2 * b]
            ms = [m[:2 * (m.shape[0] // 4)] for m in ms]
            matching = L.aux_matching_loss(m_logits[:, :b], m_logits[:, b:])

        divergence = L.discriminator_hinge_loss(logits[:, :b], logits[:, b:])
        total = divergence
        ms_div = torch.zeros((), device=logits.device)
        if self.ms_w > 0.0 and calc_ms and ms:
            for m in ms:
                half = m.shape[0] // 2
                ms_div = ms_div + L.discriminator_hinge_loss(m[:half],
                                                             m[half:])
            total = total + ms_div * self.ms_w

        gp = torch.zeros((), device=logits.device)
        if apply_gp:
            outputs = [logits, *ms]
            cots = [torch.ones_like(logits),
                    *[torch.ones_like(m) * self.ms_w for m in ms]]
            g_real, g_fake = torch.autograd.grad(
                outputs, [real, fake_aug], cots, create_graph=True,
                retain_graph=True)
            gp = 10.0 * (L.sample_sq_norms(g_real).mean()
                         + L.sample_sq_norms(g_fake).mean())
            total = total + gp

        aux = torch.zeros((), device=logits.device)
        if self.aux_w > 0.0 and aux_losses:
            aux = sum(aux_losses)
            total = total + aux * self.aux_w

        vd_div = zero
        if self.need_vd:
            vd_div, vd_gp = self._vd_d_terms(real_images, fake_aug, embeds,
                                             apply_gp)
            total = total + vd_div * self.vd_w
            if apply_gp:
                total = total + vd_gp
                gp = gp + vd_gp

        if self.want_matching and not fold:
            m_logits, _, _ = self.D(
                *self._matching_inputs(real_images, fake, fake_rgbs, rolled),
                return_multiscale_outputs=False, calc_aux_loss=False)
            matching = L.aux_matching_loss(m_logits[:, :b], m_logits[:, b:])
        if self.want_matching:
            total = total + matching * self.matching_w
        return total, dict(
            divergence=divergence, multiscale_divergence=ms_div,
            vision_aided_divergence=vd_div, matching_aware_loss=matching,
            gradient_penalty=gp, aux_reconstruction=aux)

    def _vd_d_terms(self, real, fake_aug, embeds, apply_gp):
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

    def g_step(self, batch_size, *, text_encodings=None, text_embeds=None,
               calc_ms: bool, generator, host_generator):
        """One G update (and the EMA update after it); returns its
        losses."""
        text, embeds = text_encodings, text_embeds
        params = [p for p in self.G.parameters() if p.requires_grad]
        self.g_opt.zero_grad(set_to_none=True)
        fake, rgbs = self._generate(batch_size, generator, text)
        fake_aug, rgbs_aug = self._augment(fake, rgbs, None, host_generator)
        logits, ms, _ = self.D(fake_aug, rgbs_aug, text,
                               return_multiscale_outputs=calc_ms,
                               calc_aux_loss=False)
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
            contrastive = L.clip_contrastive_loss(image_embeds, embeds,
                                                  self.clip.logit_scale)
            total = total + contrastive * self.contrastive_w
        total.backward(inputs=params)
        self.g_opt.step()
        if exists(self.ema):
            self.ema.update(self.G)
        return {k: v.detach() for k, v in dict(
            divergence=divergence, multiscale_divergence=ms_div,
            total_vd_divergence=vd_div,
            contrastive_loss=contrastive).items()}
