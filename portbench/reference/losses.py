"""The reference's GAN losses (a frozen copy of the parts of
``gigagan_tpu_torch/losses.py`` the train steps use).

The hinge losses keep the reference's inverted polarity: the
discriminator emits LOW for real and HIGH for fake, and the generator
minimizes its fake logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import numerics as nm
from portbench.reference.utils import exists


def generator_hinge_loss(fake):
    return fake.float().mean()


def discriminator_hinge_loss(real, fake):
    return (F.relu(1.0 + real.float()) + F.relu(1.0 - fake.float())).mean()


def aux_matching_loss(real, fake):
    """softplus(-x) averaged over both halves: pushes D to reject
    mismatched (image, text) pairs."""
    return (F.softplus(-real.float()) + F.softplus(-fake.float())).mean()


def clip_contrastive_loss(image_embeds, text_embeds, logit_scale):
    """Symmetric InfoNCE between l2-normalised embeds over the whole
    pool."""
    sim = nm.matmul(text_embeds.float(), image_embeds.float().t()) * logit_scale
    labels = torch.arange(sim.shape[0], device=sim.device)
    return (F.cross_entropy(sim, labels) + F.cross_entropy(sim.t(),
                                                           labels)) / 2



def sample_sq_norms(grads, eps: float = 1e-12):
    """Per-sample squared L2 norm of an input gradient, in fp32, written as
    the JAX steps write it: sqrt(Σ g² + eps)²."""
    g = grads.reshape(grads.shape[0], -1).float()
    return torch.sqrt((g * g).sum(dim=1) + eps) ** 2



class DiffAugment:
    """Differentiable augmentation, applied identically to the image and
    every multiscale rgb.  The flip is drawn from an explicit
    ``torch.Generator`` (two uniforms, as the JAX version draws two), or
    passed in."""

    def __init__(self, *, prob, horizontal_flip, horizontal_flip_prob=0.5):
        assert 0 <= prob <= 1.0
        self.prob = prob
        self.horizontal_flip = horizontal_flip
        self.horizontal_flip_prob = horizontal_flip_prob

    def draw(self, generator=None) -> bool:
        """Whether one call flips."""
        u = torch.rand(2, generator=generator)
        return bool(u[0] < self.prob and self.horizontal_flip
                    and u[1] < self.horizontal_flip_prob)

    def __call__(self, images, rgbs=None, *, flip=None, generator=None):
        if flip is None:
            flip = self.draw(generator)

        def hflip(t):
            return t.flip(2) if flip else t  # the width axis of (b, h, w, c)

        images = hflip(images)
        if exists(rgbs):
            return images, [hflip(rgb) for rgb in rgbs]
        return images
