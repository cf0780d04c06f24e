"""``GigaGAN`` (counterpart of gigagan_tpu/train/trainer.py): builds G, its
EMA copy and, for training, the discriminator and the optional
vision-aided discriminator from the same ``generator=dict(...)``,
``discriminator=dict(...)``, ``vision_aided_discriminator=dict(...)``,
``amp=`` and ``seed=`` arguments; the optimizers (the JAX trainer's
defaults: Adam, lr 2e-4, betas (0.5, 0.9), no weight decay);
``train_discriminator_step``, ``train_generator_step`` and the
``forward(steps=)``/``train(steps)`` loop
with R1 every 4th step, gradient accumulation, the 10-loss log line and
``log_hook`` record timed by ``StepTimer``, and the save-and-sample
cadence; ``save``/``load`` of the whole train state with the JAX trainer's
tolerant load; sample grids; JAX parameters through the weight bridge;
and sampling.

``fused_dg_step=True`` gives the G step the D step's batch, as JAX's fused
D+G program does, so the numbers are JAX's; the steps still run as two
sequences of kernel launches here (capturing them as CUDA graphs is what
remains of ROADMAP.md Queue 4, item 2).  ``generate`` on the card replays
G's forward as a CUDA graph captured for the request's shapes
(``train/sample_graph.py``), the upsampler's excepted.

Text conditioning (``unconditional=False`` in G and D) takes a CLIP
adapter (``clip=OpenClipAdapter(...)``), which moves to the trainer's
device and is neither trained nor saved.  A random-init CLIP or the hash
tokenizer is refused unless ``allow_mock_clip=True``.  The loader then
yields (images, captions); each batch's captions are embedded once, and
``generate(texts=[...])`` samples for captions.

Training the upsampler (``train_upsampler=True``): ``generator=dict(...)``
builds a ``UnetUpsampler``, whose ``allowable_rgb_resolutions`` must hold
the discriminator's multiscale resolutions; both steps take the real
batch, whose 'nearest' low-res copies G upsamples; ``generate(lowres)``
(or ``lowres_image=``) upsamples; the sample grids put the low-res input,
nearest-upsampled, beside each output (from ``sample_upsampler_dl``'s
batches when one is given).

Data parallel (counterpart of JAX's ``mesh=``): inside a
``torch.distributed`` process group (started from a ``torchrun``
environment by ``parallel.init_from_env`` when ``WORLD_SIZE`` > 1, or by the
caller) every rank builds the same models from the shared seed (checked
once by a checksum broadcast from rank 0), each rank's loader yields its
shard, and the steps run on the global batch (``train/steps.py``).
``device=None`` is then ``cuda:{LOCAL_RANK}``.  ``save``, the sample grids,
the log lines and ``log_hook`` run on the main process only; every rank
calls ``save`` (a barrier after it keeps the others from reading a
half-written file) and ``load``.

``load`` reads the port's ``torch.save`` checkpoints and the JAX package's
msgpack ones (``train/jax_checkpoint.py``), told apart by their leading
bytes."""

from __future__ import annotations

import copy
import time
from collections.abc import Mapping
from math import sqrt
from pathlib import Path
from typing import Optional

import numpy as np
import torch

import gigagan_tpu_torch
from gigagan_tpu_torch.convert import convert_params
from gigagan_tpu_torch.data import cycle
from gigagan_tpu_torch.losses import DiffAugment
from gigagan_tpu_torch.models.discriminator import Discriminator
from gigagan_tpu_torch.models.generator import Generator
from gigagan_tpu_torch.models.layers import init_parameters
from gigagan_tpu_torch.models.unet_upsampler import UnetUpsampler
from gigagan_tpu_torch.ops import resize_image_to
from gigagan_tpu_torch.models.vision_aided import VisionAidedDiscriminator
from gigagan_tpu_torch.parallel import dist
from gigagan_tpu_torch.train import jax_checkpoint, sample_graph
from gigagan_tpu_torch.train.ema import EMA
from gigagan_tpu_torch.train.optimizer import get_optimizer
from gigagan_tpu_torch.train.steps import TrainStepBuilder
from gigagan_tpu_torch.utils import (StepTimer, default, exists,
                                     num_to_groups, span)
from gigagan_tpu_torch.utils.png import encode_png

# the EMA's schedule, saved with its counters
_EMA_KWARGS = ("beta", "update_every", "update_after_step", "inv_gamma",
               "power", "min_value")


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
                 vision_aided_divergence_loss_weight: float = 0.5,
                 generator_contrastive_loss_weight: float = 0.1,
                 matching_awareness_loss_weight: float = 0.1,
                 calc_multiscale_loss_every: int = 1,
                 apply_gradient_penalty_every: int = 4,
                 create_ema_generator_at_init: bool = True,
                 log_steps_every: int = 20,
                 save_and_sample_every: int = 1000,
                 early_save_thres_steps: int = 2500,
                 early_save_and_sample_every: int = 100,
                 num_samples: int = 25,
                 model_folder: str = "./gigagan-models",
                 results_folder: str = "./gigagan-results",
                 amp: bool = False, remat: bool = False,
                 gp_chunk: Optional[int] = None,
                 gp_fwd_over_rev: bool = False, fused_dg_step: bool = False,
                 vision_aided_discriminator=None, clip=None,
                 allow_mock_clip: bool = False,
                 train_upsampler: bool = False,
                 resize_image_mode: str = "bilinear",
                 sample_upsampler_dl=None, seed: int = 42,
                 log_hook=None, device=None):
        distributed = dist.init_from_env()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "GigaGAN runs on a CUDA device by default and none is "
                    'available; pass device="cpu" to run on the CPU')
            device = f"cuda:{dist.local_rank()}" if distributed else "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        self.dtype = torch.bfloat16 if amp else torch.float32
        self._rng = np.random.default_rng(seed)
        init_gen = torch.Generator().manual_seed(seed)

        self.train_upsampler = train_upsampler
        self.resize_image_mode = resize_image_mode
        self.sample_upsampler_dl_iter = (
            cycle(sample_upsampler_dl) if exists(sample_upsampler_dl)
            else None)
        self.G = _promote(generator,
                          UnetUpsampler if train_upsampler else Generator,
                          dtype=self.dtype)
        init_parameters(self.G, init_gen)
        self.G.to(self.device)
        self.G_ema = copy.deepcopy(self.G).eval()
        self.G_ema.requires_grad_(False)
        self.unconditional = self.G.unconditional
        self.clip = clip
        if exists(clip):
            clip.to(self.device)
        # conditional training on a degraded CLIP (random init and/or the
        # hash tokenizer) runs end to end while learning from garbage: it
        # is loud and opt-in
        mock_reasons = list(getattr(clip, "mock_reasons", ()))
        if not self.unconditional and mock_reasons:
            details = "; ".join(mock_reasons)
            if not allow_mock_clip:
                raise ValueError(
                    "Conditional training requested but the CLIP adapter "
                    f"is a mock: {details}.  Text conditioning and the "
                    "contrastive/matching/vision-aided losses would train "
                    "against meaningless embeddings.  Provide a real "
                    "open_clip torch checkpoint via OpenClipAdapter("
                    "pretrained='/path/to/vit_b_32-laion400m_e32.pt') and "
                    "the BPE vocab via bpe_path='/path/to/"
                    "bpe_simple_vocab_16e6.txt.gz', or pass "
                    "allow_mock_clip=True to proceed anyway (tests/smoke "
                    "runs).")
            self.print(f"[gigagan_tpu_torch] WARNING: conditional training "
                       f"on a MOCK CLIP ({details}) — results will not be "
                       "meaningful")

        self.D = None
        self.VD = None
        self.ema = None
        self.builder = None
        self.steps = 1
        self.log_steps_every = log_steps_every
        self.apply_gradient_penalty_every = apply_gradient_penalty_every
        self.calc_multiscale_loss_every = calc_multiscale_loss_every
        self.fused_dg_step = fused_dg_step
        self.log_hook = log_hook
        self.save_and_sample_every = save_and_sample_every
        self.early_save_thres_steps = early_save_thres_steps
        self.early_save_and_sample_every = early_save_and_sample_every
        self.num_samples = num_samples
        self.model_folder = Path(model_folder)
        self.results_folder = Path(results_folder)
        self.train_dl = None
        if not exists(discriminator):
            dist.assert_replicated(self.G.parameters())
            return

        self.D = _promote(discriminator, Discriminator, dtype=self.dtype)
        assert self.D.unconditional == self.unconditional, (
            "the discriminator's conditioning (unconditional=...) must be "
            "the generator's")
        if train_upsampler:
            allowed = set(self.G.allowable_rgb_resolutions)
            requested = set(self.D.multiscale_input_resolutions)
            assert not (requested - allowed), (
                f"only multiscale input resolutions of {sorted(allowed)} "
                "are allowed based on the unet input and output image size")
        init_parameters(self.D, init_gen)
        self.D.to(self.device)
        opt_kwargs = dict(lr=learning_rate, wd=weight_decay, betas=betas)
        self.g_opt = get_optimizer(self.G.parameters(), **opt_kwargs)
        self.d_opt = get_optimizer(self.D.parameters(), **opt_kwargs)
        self.vd_opt = None
        if exists(vision_aided_discriminator):
            assert exists(clip), (
                "a CLIP adapter (clip=...) is required for the vision-aided "
                "discriminator")
            self.VD = _promote(vision_aided_discriminator,
                               VisionAidedDiscriminator, dtype=self.dtype)
            assert self.VD.unconditional == self.unconditional, (
                "the vision-aided discriminator's conditioning "
                "(unconditional=...) must be the generator's")
            init_parameters(self.VD, init_gen)
            self.VD.to(self.device)
            self.vd_opt = get_optimizer(self.VD.parameters(), **opt_kwargs)
        self.ema = EMA(self.G_ema) if create_ema_generator_at_init else None
        self.builder = TrainStepBuilder(
            self.G, self.D, self.g_opt, self.d_opt, ema=self.ema,
            vision_aided_discriminator=self.VD, vd_opt=self.vd_opt,
            clip=clip,
            multiscale_divergence_loss_weight=(
                multiscale_divergence_loss_weight),
            vision_aided_divergence_loss_weight=(
                vision_aided_divergence_loss_weight),
            generator_contrastive_loss_weight=(
                generator_contrastive_loss_weight),
            matching_awareness_loss_weight=matching_awareness_loss_weight,
            discr_aux_recon_loss_weight=discr_aux_recon_loss_weight,
            diff_augment=_promote(diff_augment, DiffAugment),
            gp_chunk=gp_chunk, gp_fwd_over_rev=gp_fwd_over_rev,
            remat=remat, train_upsampler=train_upsampler,
            input_image_size=(self.G.input_image_size if train_upsampler
                              else None),
        )
        dist.assert_replicated([
            *self.G.parameters(), *self.D.parameters(),
            *(self.VD.parameters() if exists(self.VD) else ())])

    # ----------------------------------------------------------- plumbing

    @property
    def is_main(self) -> bool:
        """Whether this is the main process (rank 0, or no process
        group)."""
        return dist.is_main()

    def print(self, msg):
        if self.is_main:
            print(msg, flush=True)

    # ------------------------------------------------------------ weights

    def load_jax_params(self, g_params, ema_params=None, d_params=None,
                        vd_params=None, vd_buffers=None):
        """Load JAX parameter trees (nested mappings of arrays): the
        generator's, its EMA copy's (``g_params`` without one), the
        discriminator's and the vision-aided discriminator's (its
        ``params`` and ``buffers`` collections)."""
        self.G.load_state_dict(convert_params(g_params, self.G))
        self.G_ema.load_state_dict(convert_params(
            g_params if ema_params is None else ema_params, self.G_ema
        ))
        if exists(d_params):
            self.D.load_state_dict(convert_params(d_params, self.D))
        if exists(vd_params):
            self.VD.load_state_dict(convert_params(vd_params, self.VD,
                                                   buffers=vd_buffers))

    def create_ema_generator(self, update_every: int = 10,
                             update_after_step: int = 100,
                             decay: float = 0.995):
        """Start an EMA of G from its current parameters."""
        assert not exists(self.ema), "EMA generator already created"
        self.G_ema.load_state_dict(self.G.state_dict())
        self.ema = EMA(self.G_ema, beta=decay, update_every=update_every,
                       update_after_step=update_after_step)
        if exists(self.builder):
            self.builder.ema = self.ema

    # -------------------------------------------------------------- steps

    def _generators(self, seed: Optional[int]):
        """(device generator, host generator) from one seed."""
        if seed is None:
            seed = int(self._rng.integers(2 ** 63))
        s_dev, s_host = np.random.SeedSequence(seed).generate_state(2)
        return (torch.Generator(device=self.device).manual_seed(int(s_dev)),
                torch.Generator().manual_seed(int(s_host)))

    def _check_trainable(self):
        if not exists(self.builder):
            raise RuntimeError("GigaGAN was built without a discriminator")

    def _device_batch(self, batch, grad_accum_every: int):
        """(reals, text encodings, text embeds) on the device: the reals
        (b, h, w, c) split into ``grad_accum_every`` microbatches, or
        already (grad_accum_every, mb, h, w, c); a conditional batch is a
        mapping with ``real_images`` and the CLIP ``text_encodings`` and
        ``text_embeds`` of its samples, laid out alike."""
        if isinstance(batch, Mapping):
            parts = [batch.get(k) for k in ("real_images", "text_encodings",
                                            "text_embeds")]
        else:
            parts = [batch, None, None]
        if not self.unconditional:
            assert exists(parts[1]), (
                "a conditional step needs the batch's text_encodings")
        with span("gigagan.sync.batch_to_device"):
            real = torch.as_tensor(parts[0], device=self.device)
        accumulated = real.dim() == 5
        if not accumulated and grad_accum_every > 1:
            accumulated = True
            parts = [None if p is None else torch.as_tensor(p).reshape(
                grad_accum_every, -1, *p.shape[1:]) for p in parts]
            with span("gigagan.sync.batch_to_device"):
                real = torch.as_tensor(parts[0], device=self.device)
        assert not accumulated or real.shape[0] == grad_accum_every, (
            f"batch leading dim {real.shape[0]} != grad_accum "
            f"{grad_accum_every}")
        return (real, *(None if p is None else
                        torch.as_tensor(p, device=self.device)
                        for p in parts[1:]))

    def train_discriminator_step(self, batch, *, grad_accum_every: int = 1,
                                 apply_gradient_penalty: bool,
                                 calc_multiscale_loss: bool, draws=None,
                                 seed: Optional[int] = None) -> dict:
        """One D (and vision-aided D) update on a batch of real images in
        [0, 1] (numpy array or tensor): (b, h, w, c), split into
        ``grad_accum_every`` microbatches, or (grad_accum_every, mb, h, w,
        c); conditional, a mapping as ``_collect_batch`` returns.
        ``draws`` fixes the step's random draws (``train.steps.StepDraws``,
        one per microbatch)."""
        self._check_trainable()
        with span("gigagan.train.d_step"):
            real, text, embeds = self._device_batch(batch, grad_accum_every)
            gen, host = self._generators(seed)
            return self.builder.d_step(
                real, text_encodings=text, text_embeds=embeds,
                apply_gp=apply_gradient_penalty,
                calc_ms=calc_multiscale_loss, draws=draws, generator=gen,
                host_generator=host,
            )

    def train_generator_step(self, batch, *, grad_accum_every: int = 1,
                             calc_multiscale_loss: bool, draws=None,
                             seed: Optional[int] = None) -> dict:
        """One G update on ``grad_accum_every`` microbatches of ``batch``
        fakes each (an int), or, conditional or training the upsampler, on
        a batch as ``train_discriminator_step`` takes it (its texts, or the
        reals whose low-res copies G upsamples); then the EMA update;
        advances the step counter."""
        self._check_trainable()
        text = embeds = None
        with span("gigagan.train.g_step"):
            if isinstance(batch, int):
                assert not self.train_upsampler, (
                    "the upsampler's generator step takes the real batch")
                g_batch = batch
            else:
                real, text, embeds = self._device_batch(batch,
                                                        grad_accum_every)
                g_batch = real if self.train_upsampler else real.shape[-4]
            gen, host = self._generators(seed)
            metrics = self.builder.g_step(
                g_batch, text_encodings=text, text_embeds=embeds,
                calc_ms=calc_multiscale_loss,
                grad_accum_every=grad_accum_every, draws=draws,
                generator=gen, host_generator=host,
            )
        self.steps += 1
        return metrics

    def set_dataloader(self, dl):
        assert not exists(self.train_dl), (
            "training dataloader has already been set")
        self.train_dl = dl

    def embed_texts(self, texts):
        """Captions → CLIP token encodings (b, n, d) on the device."""
        return self._embed_texts_full(texts)[1]

    def _embed_texts_full(self, texts):
        """(global embed, token encodings) of the captions."""
        assert exists(self.clip), (
            "a CLIP adapter must be attached (clip=...) to embed raw texts")
        with span("gigagan.clip.embed_texts"):
            return self.clip.embed_texts(list(texts))

    def _collect_batch(self, dl_iter, grad_accum_every: int):
        """``grad_accum_every`` batches of the loader, stacked as
        (grad_accum_every, mb, h, w, c); conditional, a mapping with the
        CLIP ``text_encodings`` and ``text_embeds`` of the batches'
        captions, each batch's embedded once, laid out alike."""
        with span("gigagan.train.batch"):
            images, encodings, embeds = [], [], []
            for _ in range(grad_accum_every):
                with span("gigagan.train.data_wait"):
                    result = next(dl_iter)
                if self.unconditional:
                    (real,) = (result if isinstance(result, tuple)
                               else (result,))
                else:
                    assert isinstance(result, tuple), (
                        "dataset should return (images, texts) for text-"
                        "conditioned training")
                    real, texts = result
                    embed, enc = self._embed_texts_full(texts)
                    encodings.append(enc)
                    embeds.append(embed)
                images.append(np.asarray(real))
            images = np.stack(images)
            if self.unconditional:
                return images
            return {"real_images": images,
                    "text_encodings": torch.stack(encodings),
                    "text_embeds": torch.stack(embeds)}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def forward(self, *, steps: int, grad_accum_every: int = 1):
        """The alternating loop: a D step then a G step per iteration, each
        on a batch of its own (the G step on the D step's with
        ``fused_dg_step``), R1 on every ``apply_gradient_penalty_every``-th
        step, the multiscale losses on every
        ``calc_multiscale_loss_every``-th.  On logging steps it
        synchronises, prints the 10-loss line (the last R1 and multiscale
        values carried over, as JAX prints them) and hands ``log_hook``
        JAX's record; it saves samples and a checkpoint on the JAX
        trainer's cadence.  Returns the losses of each logged step as
        floats."""
        assert exists(self.train_dl), (
            "set the dataloader first with .set_dataloader(dl)")
        self._check_trainable()
        dl_iter = cycle(self.train_dl)
        last = dict(gp=0.0, msd=0.0, msg=0.0)
        self.step_timer = StepTimer()
        steps_since_sync = 0
        log = []
        t0 = time.perf_counter()
        for _ in range(steps):
            with span("gigagan.train.iteration"):
                step = self.steps
                is_first = step == 1
                self.step_timer.start()
                apply_gp = (self.apply_gradient_penalty_every > 0
                            and step % self.apply_gradient_penalty_every
                            == 0)
                calc_ms = (self.calc_multiscale_loss_every > 0
                           and step % self.calc_multiscale_loss_every == 0)

                d_batch = self._collect_batch(dl_iter, grad_accum_every)
                reals = (d_batch if self.unconditional
                         else d_batch["real_images"])
                d = self.train_discriminator_step(
                    d_batch, grad_accum_every=grad_accum_every,
                    apply_gradient_penalty=apply_gp,
                    calc_multiscale_loss=calc_ms)
                # the fused step is unconditional and not the upsampler's,
                # as in JAX
                fused = (self.fused_dg_step and self.unconditional
                         and not self.train_upsampler)
                g_batch = (d_batch if fused else
                           self._collect_batch(dl_iter, grad_accum_every))
                # the unconditional image g_step reads only the batch's size
                g = self.train_generator_step(
                    g_batch.shape[1] if self.unconditional
                    and not self.train_upsampler else g_batch,
                    grad_accum_every=grad_accum_every,
                    calc_multiscale_loss=calc_ms)

                steps_since_sync += 1
                if is_first or step % self.log_steps_every == 0:
                    with span("gigagan.train.log"):
                        self._sync()
                        self.step_timer.stop(steps_since_sync)
                        steps_since_sync = 0
                        d = {k: float(v) for k, v in d.items()}
                        g = {k: float(v) for k, v in g.items()}
                        if apply_gp:
                            last["gp"] = d["gradient_penalty"]
                        if calc_ms:
                            last["msd"] = d["multiscale_divergence"]
                            last["msg"] = g["multiscale_divergence"]
                        pairs = (("G", g["divergence"]), ("MSG", last["msg"]),
                                 ("VG", g["total_vd_divergence"]),
                                 ("D", d["divergence"]), ("MSD", last["msd"]),
                                 ("VD", d["vision_aided_divergence"]),
                                 ("GP", last["gp"]),
                                 ("SSL", d["aux_reconstruction"]),
                                 ("CL", g["contrastive_loss"]),
                                 ("MAL", d["matching_aware_loss"]))
                        # the global batch: every rank's
                        bs = (reals.shape[0] * reals.shape[1]
                              * dist.world_size())
                        self.print(f"step {step}: " + " | ".join(
                            f"{k}: {v:.2f}" for k, v in pairs)
                            + f" | {self.step_timer.summary(bs)}")
                        timing = {"ms_per_step": self.step_timer.mean_s * 1e3,
                                  "images_per_sec":
                                      self.step_timer.images_per_sec(bs)}
                        if exists(self.log_hook) and self.is_main:
                            self.log_hook({"step": step, **dict(pairs),
                                           **timing})
                        log.append({"step": step,
                                    **{f"d_{k}": v for k, v in d.items()},
                                    **{f"g_{k}": v for k, v in g.items()},
                                    "seconds": time.perf_counter() - t0,
                                    **timing})

                if is_first or step % self.save_and_sample_every == 0 or (
                        step <= self.early_save_thres_steps
                        and step % self.early_save_and_sample_every == 0):
                    self.save_sample(reals.shape[1], dl_iter)
        with span("gigagan.train.loader_close"):
            dl_iter.close()  # the loader's threads end here
        self.print(f"complete {self.steps} training steps")
        return log

    def train(self, steps: int, grad_accum_every: int = 1):
        return self.forward(steps=steps, grad_accum_every=grad_accum_every)

    def __call__(self, *, steps: int, grad_accum_every: int = 1):
        return self.forward(steps=steps, grad_accum_every=grad_accum_every)

    # ----------------------------------------------------------- sampling

    @property
    def has_ema_generator(self) -> bool:
        """Whether ``G_ema`` holds an EMA generator: a trainer's when it
        keeps one (``create_ema_generator_at_init`` or
        ``create_ema_generator``), and a sampler's (built without a
        discriminator), whose ``G_ema`` is what ``load_jax_params``
        loaded."""
        return exists(self.ema) or not exists(self.D)

    @torch.inference_mode()
    def generate(self, *args, batch_size: int = 4, styles=None, noise=None,
                 texts=None, text_encodings=None, lowres_image=None,
                 seed: Optional[int] = None, use_ema: bool = True):
        """Sample from the EMA generator, or from the trained one with
        ``use_ema=False`` or when there is no EMA generator (as JAX's
        ``_generate_params``).  ``styles``/``noise`` (the style latent)
        override the drawn latent.  Conditional: one sample per caption of
        ``texts`` (embedded by the CLIP adapter) or per row of CLIP
        ``text_encodings``.  The upsampler upsamples ``lowres_image`` (b,
        h, w, c) in [0, 1], also given as the one positional argument.
        Returns a float32 (b, h, w, 3) numpy array."""
        with span("gigagan.sample.request"):
            if args:
                assert len(args) == 1 and lowres_image is None and (
                    self.train_upsampler), (
                    "positional argument must be the lowres image "
                    "(upsampler)")
                lowres_image = args[0]
            if exists(texts):
                text_encodings = self.embed_texts(texts)
            if exists(text_encodings):
                text_encodings = torch.as_tensor(text_encodings,
                                                 device=self.device)
            g = self.G_ema if use_ema and self.has_ema_generator else self.G
            if seed is None:
                seed = int(self._rng.integers(2 ** 63))
            seeds = tuple(map(int, np.random.SeedSequence(
                seed).generate_state(2)))  # (noise, latent)
            if exists(styles):
                styles = torch.as_tensor(styles, device=self.device)
            if exists(noise):
                noise = torch.as_tensor(noise, device=self.device)
            inputs = dict(styles=styles, noise=noise,
                          text_encodings=text_encodings)
            key = sample_graph.graph_key(self.device, self.train_upsampler,
                                         batch_size, g.dtype, inputs)
            with span("gigagan.sample.generator"):
                if self.train_upsampler:
                    assert exists(lowres_image), (
                        "the upsampler needs lowres_image")
                    latent_gen = torch.Generator(
                        device=self.device).manual_seed(seeds[1])
                    with span("gigagan.sync.lowres_to_device"):
                        lowres = torch.as_tensor(lowres_image,
                                                 device=self.device)
                    out = g(lowres, **inputs, latent_generator=latent_gen)
                else:
                    out = sample_graph.forward(g, key, self.device,
                                               batch_size, seeds, inputs)
            with span("gigagan.sync.readback"):
                return out.float().cpu().numpy()

    def _sample_images(self, batch_size: int, use_ema: bool, dl_iter=None):
        """``num_samples`` samples in groups of ``batch_size``; the
        upsampler's groups are [nearest-upsampled low-res inputs;
        outputs], as JAX lays them out."""
        rows = []
        for n in num_to_groups(self.num_samples, batch_size):
            kwargs = dict(batch_size=n, use_ema=use_ema)
            if self.train_upsampler or not self.unconditional:
                result = next(dl_iter)
                real = result[0] if isinstance(result, tuple) else result
                if not self.unconditional:  # the captions of the batch
                    kwargs["texts"] = list(result[1])[:n]
                if self.train_upsampler:
                    kwargs["lowres_image"] = resize_image_to(
                        torch.as_tensor(np.asarray(real[:n])),
                        self.G.input_image_size, "nearest")
            out = self.generate(**kwargs)
            if self.train_upsampler:
                up = resize_image_to(kwargs["lowres_image"], out.shape[1],
                                     "nearest")
                out = np.concatenate([up.float().numpy(), out], axis=0)
            rows.append(out)
        return np.clip(np.concatenate(rows, axis=0), 0.0, 1.0)

    def save_sample(self, batch_size: int, dl_iter=None):
        """Grids of ``num_samples`` samples from the trained generator
        (``sample-{m}.png``) and, with an EMA, from the EMA generator
        (``ema-sample-{m}.png``) into ``results_folder``, then a
        checkpoint ``model-{m}.ckpt`` into ``model_folder``, m being the
        save milestone.  Conditional, the captions come from ``dl_iter``'s
        batches; the upsampler's low-res inputs from
        ``sample_upsampler_dl``'s, or else ``dl_iter``'s, and its grids
        are twice as wide.  Every rank samples (so that the host RNG and the
        loader advance alike); the main process writes."""
        if self.train_upsampler:
            dl_iter = default(self.sample_upsampler_dl_iter, dl_iter)
        assert exists(dl_iter) or (self.unconditional
                                   and not self.train_upsampler)
        milestone = self.steps // self.save_and_sample_every
        nrow = int(sqrt(self.num_samples)) * (2 if self.train_upsampler
                                              else 1)
        variants = [("sample", False)]
        if self.has_ema_generator:
            variants.append(("ema-sample", True))
        if self.is_main:
            self.results_folder.mkdir(parents=True, exist_ok=True)
        for prefix, use_ema in variants:
            grid = self._sample_images(batch_size, use_ema, dl_iter)
            if self.is_main:
                save_image_grid(
                    grid, self.results_folder / f"{prefix}-{milestone}.png",
                    nrow=nrow)
        self.save(self.model_folder / f"model-{milestone}.ckpt")

    # -------------------------------------------------------- checkpoints

    def _state(self) -> dict:
        """Everything a resume needs, by name."""
        state = {"G": self.G.state_dict(), "G_ema": self.G_ema.state_dict(),
                 "steps": self.steps,
                 "rng": self._rng.bit_generator.state,
                 "version": gigagan_tpu_torch.__version__}
        if exists(self.D):
            state.update(D=self.D.state_dict(),
                         g_opt=self.g_opt.state_dict(),
                         d_opt=self.d_opt.state_dict())
        if exists(self.VD):  # the CLIP is frozen and not saved
            state.update(VD=self.VD.state_dict(),
                         vd_opt=self.vd_opt.state_dict())
        if exists(self.ema):
            state["ema"] = {"step": self.ema.step,
                            "initted": self.ema.initted,
                            **{k: getattr(self.ema, k)
                               for k in _EMA_KWARGS}}
        return state

    def save(self, path, overwrite: bool = True):
        """One ``torch.save`` file of the train state: G, G_ema, D, the
        vision-aided D, their optimizers, the EMA's counters and schedule,
        the step counter, the numpy RNG's ``bit_generator.state`` and the
        package version.
        Written to a temporary file and renamed over ``path``, so that a
        crash mid-save leaves an earlier checkpoint whole; a directory at
        ``path`` (a JAX orbax checkpoint of the same name) raises
        ``FileExistsError`` and is left as it is.  In a process group every
        rank calls it: the main process writes, and the others wait at a
        barrier until the file is whole."""
        path = Path(path)
        if path.is_dir():
            raise FileExistsError(
                f"{path} is a directory (a JAX orbax checkpoint?): the port "
                "writes single-file checkpoints and does not replace it")
        if self.is_main:
            path.parent.mkdir(parents=True, exist_ok=True)
            assert overwrite or not path.exists()
            tmp = path.with_name(path.name + ".tmp")
            torch.save(self._state(), tmp)
            tmp.replace(path)
        dist.barrier()

    def load(self, path, strict: bool = False):
        """Restore a checkpoint: the port's ``torch.save`` file, or the JAX
        package's msgpack file or orbax directory
        (``load_jax_checkpoint``), told apart by the leading bytes.

        Tolerant by default, as the JAX trainer's ``load``: model and EMA
        tensors that match by name and shape are loaded; on a mismatch
        the live value is kept and the count and the first name are
        printed.  An optimizer state that does not fit as a whole is reset
        fresh.  ``strict=True`` raises on any mismatch instead."""
        path = Path(path)
        assert path.exists(), path
        if jax_checkpoint.checkpoint_format(path) == "torch":
            saved = torch.load(path, map_location="cpu", weights_only=True)
        else:
            saved = jax_checkpoint.port_state(
                jax_checkpoint.read_checkpoint(path), self)
            self.print("the checkpoint's JAX PRNG key cannot seed torch's "
                       "generators: the host RNG keeps its state")
        version = saved.get("version")
        if version is not None and version != gigagan_tpu_torch.__version__:
            self.print(f"trying to load from version {version}")
        skipped = []
        modules = (("G", self.G), ("G_ema", self.G_ema), ("D", self.D),
                   ("VD", self.VD))
        loads = [(module, _matching(module, saved.get(key), key, skipped))
                 for key, module in modules if exists(module)]
        skipped.extend(f"{key} (unexpected in checkpoint)"
                       for key, module in modules
                       if not exists(module) and key in saved)
        if exists(self.ema) != ("ema" in saved):
            skipped.append("ema (missing from checkpoint)" if exists(self.ema)
                           else "ema (unexpected in checkpoint)")
        opts = [(key, getattr(self, key))
                for key in ("g_opt", "d_opt", "vd_opt")
                if exists(getattr(self, key, None))]
        misfits = [key for key, opt in opts
                   if not _optimizer_fits(opt, saved.get(key))]
        if strict and (skipped or misfits):
            raise RuntimeError(f"checkpoint {path} does not match: "
                               + "; ".join(skipped + [
                                   f"{k} does not fit" for k in misfits]))
        if skipped:
            self.print(f"checkpoint load: kept live values for "
                       f"{len(skipped)} incompatible entries (first: "
                       f"{skipped[0]})")
        for module, tensors in loads:
            module.load_state_dict(tensors, strict=False)
        if exists(self.ema) and "ema" in saved:
            for k in ("step", "initted", *_EMA_KWARGS):
                if k in saved["ema"]:  # a JAX EMA keeps its counters only
                    setattr(self.ema, k, saved["ema"][k])
        # optimizer states are all-or-nothing: reset when one does not fit
        for key, opt in opts:
            if key in misfits:
                self.print(f"unable to load {key} state; {key} will be "
                           "reset to a fresh optimizer")
                opt.state.clear()
            else:
                opt.load_state_dict(saved[key])
        self.steps = int(saved["steps"])
        if "rng" in saved:
            self._rng.bit_generator.state = saved["rng"]

    def load_jax_checkpoint(self, path, strict: bool = False):
        """Restore a checkpoint written by the JAX package's
        ``GigaGAN.save`` (``model-N.ckpt``: a flax msgpack file, or an
        orbax directory under ``checkpoint_backend="orbax"``), as ``load``
        does: parameters through the weight bridge, the EMA's params and
        counters, the step counter and the Adam moments of either optimizer
        layout (``train/jax_checkpoint.py``, ``train/orbax_checkpoint.py``).
        Its JAX PRNG key cannot seed torch's generators, so the host RNG
        keeps its state."""
        if jax_checkpoint.checkpoint_format(path) == "torch":
            raise ValueError(f"{path} is not a JAX checkpoint")
        self.load(path, strict=strict)


def _matching(module, saved, name, skipped) -> dict:
    """The tensors of ``saved`` that match ``module``'s by name and shape;
    the others are recorded in ``skipped``."""
    if saved is None:
        skipped.append(f"{name} (missing from checkpoint)")
        return {}
    live = module.state_dict()
    keep = {}
    for k, v in live.items():
        if k not in saved:
            skipped.append(f"{name}.{k} (missing from checkpoint)")
        elif tuple(saved[k].shape) != tuple(v.shape):
            skipped.append(f"{name}.{k} (shape {tuple(saved[k].shape)} != "
                           f"{tuple(v.shape)})")
        else:
            keep[k] = saved[k]
    skipped.extend(f"{name}.{k} (unexpected in checkpoint)"
                   for k in saved if k not in live)
    return keep


def _optimizer_fits(opt, saved) -> bool:
    """Whether a saved optimizer state_dict fits ``opt`` as a whole: the
    same groups of the same sizes, and every state tensor of a parameter
    either a scalar or of the parameter's shape."""
    if not isinstance(saved, Mapping) or "param_groups" not in saved:
        return False
    groups = opt.param_groups
    if [len(g["params"]) for g in groups] != [
            len(g["params"]) for g in saved["param_groups"]]:
        return False
    params = [p for g in groups for p in g["params"]]
    ids = [i for g in saved["param_groups"] for i in g["params"]]
    for p, i in zip(params, ids):
        for v in saved["state"].get(i, {}).values():
            if torch.is_tensor(v) and v.dim() and v.shape != p.shape:
                return False
    return True


def save_image_grid(images, path, nrow: int):
    """(n, h, w, c) float [0, 1] → a PNG grid with the JAX trainer's
    pixels (torchvision ``save_image``'s layout: 2-pixel borders on a
    background of ones), written by the standard library alone."""
    n, h, w, c = images.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.ones((nrows * h + (nrows + 1) * 2,
                    ncol * w + (ncol + 1) * 2, c), np.float32)
    for i in range(n):
        r, cl = divmod(i, ncol)
        top = r * h + (r + 1) * 2
        left = cl * w + (cl + 1) * 2
        grid[top:top + h, left:left + w] = images[i]
    arr = (grid * 255).astype(np.uint8)
    if c == 1:
        arr = arr[..., 0]
    Path(path).write_bytes(encode_png(arr))
