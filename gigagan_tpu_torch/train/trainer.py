"""``GigaGAN``, generator side (counterpart of the sampling half of
gigagan_tpu/train/trainer.py): builds G and its EMA copy from the same
``generator=dict(...)``, ``amp=`` and ``seed=`` arguments, loads JAX
parameters through the weight bridge, and samples.  The discriminator and
the train steps are not ported yet (ROADMAP.md Queue 1, item 2)."""

from __future__ import annotations

import copy
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from gigagan_tpu_torch.convert import convert_params
from gigagan_tpu_torch.models.generator import Generator
from gigagan_tpu_torch.models.layers import init_parameters
from gigagan_tpu_torch.utils import exists


class GigaGAN:
    def __init__(self, *, generator, discriminator=None, amp: bool = False,
                 seed: int = 42, device=None):
        if exists(discriminator):
            raise NotImplementedError(
                "the discriminator and the train steps are not ported yet "
                "(ROADMAP.md Queue 1, item 2)"
            )
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if amp else torch.float32

        if isinstance(generator, Mapping):
            generator = Generator(**generator, dtype=self.dtype)
        self.G = generator
        init_parameters(self.G, torch.Generator().manual_seed(seed))
        self.G.to(self.device).eval()
        self.G_ema = copy.deepcopy(self.G)
        self._rng = np.random.default_rng(seed)

    def load_jax_params(self, g_params, ema_params=None):
        """Load a JAX generator param tree (nested mappings of arrays);
        the EMA copy takes ``ema_params``, or ``g_params`` without them."""
        self.G.load_state_dict(convert_params(g_params, self.G))
        self.G_ema.load_state_dict(convert_params(
            g_params if ema_params is None else ema_params, self.G_ema
        ))

    def _generators(self, seed: Optional[int]):
        if seed is None:
            seed = int(self._rng.integers(2 ** 63))
        s_noise, s_latent = np.random.SeedSequence(seed).generate_state(2)
        return (
            torch.Generator(device=self.device).manual_seed(int(s_noise)),
            torch.Generator(device=self.device).manual_seed(int(s_latent)),
        )

    @torch.inference_mode()
    def generate(self, batch_size: int = 4, styles=None, noise=None,
                 seed: Optional[int] = None, use_ema: bool = True):
        """Sample from the (EMA) generator; ``use_ema=False`` samples the
        raw generator.  ``styles``/``noise`` (the style latent) override
        the drawn latent.  Returns a float32 (b, h, w, 3) numpy array."""
        g = self.G_ema if use_ema else self.G
        noise_gen, latent_gen = self._generators(seed)
        if exists(styles):
            styles = torch.as_tensor(styles, device=self.device)
        if exists(noise):
            noise = torch.as_tensor(noise, device=self.device)
        out = g(styles=styles, noise=noise, batch_size=batch_size,
                latent_generator=latent_gen, noise_generator=noise_gen)
        return out.float().cpu().numpy()
