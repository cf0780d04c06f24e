"""The reference trainer of the UNet upsampler (``train_upsampler=True``):
the models of a configuration built in float32 (the reference's
``UnetUpsampler`` as G, its ``Discriminator``), their weights drawn from a
seed, and the port trainer's loop over them, with the two changes the
port's steps make for the upsampler (``gigagan_tpu_torch/train/steps.py``
``_generate`` and ``g_step``):

- G reads the reals resized to its input size by 'nearest' (torch's
  legacy floor index), and draws only its style latent from the step's
  device generator;
- the G step takes the loader's real batch (its low-res copies are what G
  upsamples), not a batch size.

The same interface as ``reference/trainer.py`` (``make_weights``,
``ReferenceTrainer``), so the train driver's check and operation count
run on it unchanged.  Its steps compute in IEEE float32
(``strict_float32``)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import trainer as base
from portbench.reference.discriminator import Discriminator
from portbench.reference.init import init_modules
from portbench.reference.ops import resize_image_to
from portbench.reference.steps import TrainSteps
from portbench.reference.unet_upsampler import UnetUpsampler


@contextlib.contextmanager
def strict_float32():
    """float32 products and convolutions in IEEE float32 while open: torch
    lets cuDNN round a float32 convolution's operands to TF32 (10-bit
    mantissas) by default, on the card."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def build_models(config: dict, device) -> dict:
    """{'G', 'D', 'VD', 'clip'} of ``config`` (no VD, no CLIP), float32, on
    ``device``, every parameter and buffer NaN until drawn."""
    with torch.device(device):
        models = {"G": UnetUpsampler(**config["generator"]),
                  "D": Discriminator(**config["discriminator"]),
                  "VD": None, "clip": None}
    with torch.no_grad():
        for m in (models["G"], models["D"]):
            for t in (*m.parameters(), *m.buffers()):
                t.fill_(float("nan"))
    return models


def make_weights(config: dict, seed: int, device) -> dict:
    """The models of ``config`` with the weights of ``seed``: G then D
    drawn from one standard normal made on the device."""
    models = build_models(config, device)
    init_modules([models["G"], models["D"]], seed, device)
    for name in ("G", "D"):
        for key, t in models[name].state_dict().items():
            if not torch.isfinite(t).all():
                raise RuntimeError(f"{name}.{key} was not drawn")
    return models


class UpsamplerSteps(TrainSteps):
    """The reference's steps with G upsampling the low-res copies of each
    step's reals."""

    def __init__(self, *args, input_image_size: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.input_image_size = input_image_size
        self.lowres = None

    def _generate(self, batch_size, generator, text=None):
        assert self.lowres.shape[0] == batch_size
        return self.G(self.lowres, return_all_rgbs=True,
                      latent_generator=generator)

    def d_step(self, real_images, **kwargs):
        self.lowres = resize_image_to(real_images, self.input_image_size,
                                      "nearest")
        return super().d_step(real_images, **kwargs)

    def g_step(self, reals, **kwargs):
        self.lowres = resize_image_to(reals, self.input_image_size,
                                      "nearest")
        return super().g_step(reals.shape[0], **kwargs)


class ReferenceTrainer(base.ReferenceTrainer):
    """The port trainer's alternating loop over the reference upsampler and
    D; ``seed`` is the trainer's, as in ``reference/trainer.py``."""

    def __init__(self, models: dict, config: dict, *, seed: int, device):
        super().__init__(models, config, seed=seed, device=device)
        opts = {**base.TRAINER_DEFAULTS, **config.get("trainer", {})}
        assert opts.get("train_upsampler") and not opts.get("diff_augment")
        self.steps_fn = UpsamplerSteps(
            self.G, self.D, self.g_opt, self.d_opt, ema=self.ema,
            weights={k: opts[k] for k in base.LOSS_WEIGHTS},
            input_image_size=self.G.input_image_size)

    def _reals(self, batch):
        images, captions = batch
        assert captions is None, "the upsampler is unconditional"
        return torch.as_tensor(np.asarray(images),
                               device=self.device).float()

    def iteration(self, d_batch, g_batch, rows=None):
        """One iteration on the loader's two batches (images (b, h, w, c)
        in [0, 1], None); returns (D losses, G losses).  ``rows``: the D
        step's block of samples (``TrainSteps.d_step``)."""
        step = self.steps
        apply_gp = self.apply_gp_every > 0 and step % self.apply_gp_every == 0
        calc_ms = self.calc_ms_every > 0 and step % self.calc_ms_every == 0
        with strict_float32():
            gen, host = base.step_generators(
                int(self.rng.integers(2 ** 63)), self.device)
            d = self.steps_fn.d_step(self._reals(d_batch), apply_gp=apply_gp,
                                     calc_ms=calc_ms, generator=gen,
                                     host_generator=host, rows=rows)
            gen, host = base.step_generators(
                int(self.rng.integers(2 ** 63)), self.device)
            g = self.steps_fn.g_step(self._reals(g_batch), calc_ms=calc_ms,
                                     generator=gen, host_generator=host)
        self.steps += 1
        return d, g
