"""Multiscale discriminator, dense (counterpart of
gigagan_tpu/models/discriminator.py with ``s2d_trunk=False``; the JAX
package's space-to-depth trunk has identical parameters and exact math and
exists only for the TPU's lane layout).

- conv pyramid to 4x4; at each multiscale input resolution the rgb is
  from_rgb-projected, ADDED to the stem and CONCATENATED on the batch dim
  (deeper weights reused as extra scales) in batch-MAJOR group order: row
  ``i*s + g`` is sample ``i``, scale group ``g``;
- predictor heads read only the rows of the groups that existed before
  the stage; the aux reconstruction decoder reads scale-group-0 rows;
- final logits in the ``(s, b)`` layout;
- conditional (``unconditional=False``): the text embedding (from its own
  TextEncoder over CLIP token encodings, or given as ``text_embeds``) is
  projected once to one (mod, kernel_mod) pair per predictor, whose
  stacked convs are adaptive convs sharing that pair.

Random draws (the decoder's dropout mask and patch choice) come from an
explicit ``torch.Generator``, or are passed in (``recon_draws``) so a
caller can reproduce another run's draws.

``remat_stages`` recomputes each stage core (``DStageCore``) in the
backward (``utils.remat``: a non-reentrant checkpoint), as the JAX
discriminator wraps it in ``nn.remat``: the R1 double backward then holds
one stage's activations at a time.  A core draws nothing, so its
recomputation is exact.
"""

from __future__ import annotations

from collections.abc import Mapping
from math import log2
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from gigagan_tpu_torch import ops
from gigagan_tpu_torch.models.conditioning import TextEncoder
from gigagan_tpu_torch.models.layers import (
    AdaptiveConv,
    Conv,
    Downsample,
    SelfAttentionBlock,
    SqueezeExcite,
    conv1x1,
    conv3x3,
    leaky_relu,
)
from gigagan_tpu_torch.ops.adaptive_conv import expand_batch
from gigagan_tpu_torch.parallel import dist
from gigagan_tpu_torch.utils import (
    ModTable,
    default,
    exists,
    is_power_of_two,
)
from gigagan_tpu_torch.utils.remat import remat


def _patches(t, p):
    """(b, p·h, p·w, c) → (b, p·p, h, w, c), patch-major like einops'
    'b (p1 h) (p2 w) c -> b (p1 p2) h w c'."""
    b, hh, ww, c = t.shape
    t = t.reshape(b, p, hh // p, p, ww // p, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, p * p, hh // p, ww // p, c)


class SimpleDecoder(nn.Module):
    """Aux self-supervised reconstruction head: dropout → optional random
    patch subsample → upsample conv stack → MSE against the input image."""

    def __init__(self, dim: int, dims: Sequence[int], patch_dim: int = 1,
                 frac_patches: float = 1.0, dropout: float = 0.5,
                 dtype=torch.float32):
        super().__init__()
        assert 0 < frac_patches <= 1.0
        self.patch_dim = patch_dim
        self.frac_patches = frac_patches
        self.dropout = dropout
        self.conv_in = conv3x3(dim, dim, dtype=dtype)
        all_dims = [dim, *dims]
        for i, (dim_in, dim_out) in enumerate(zip(all_dims[:-1],
                                                  all_dims[1:])):
            self.add_module(f"conv_{i}", conv3x3(dim_in, dim_out,
                                                 dtype=dtype))
        self.depth = len(dims)

    @property
    def num_patches(self):
        total = self.patch_dim ** 2
        return total, max(int(self.frac_patches * total), 1)

    def draw(self, fmap_shape, generator=None, device=None):
        """(keep mask (b, h, w, c) bool or None, patch indices (b, num) or
        None) for one call, from ``generator``."""
        keep = idx = None
        if self.dropout > 0.0:
            keep = dist.rand(fmap_shape, generator=generator,
                              device=device) < 1.0 - self.dropout
        if self.frac_patches < 1.0:
            total, num = self.num_patches
            scores = dist.rand((fmap_shape[0], total), generator=generator,
                                device=device)
            idx = torch.argsort(scores, dim=-1, stable=True)[:, :num]
        return keep, idx

    def forward(self, fmap, orig_image, deterministic: bool = False,
                keep=None, patch_idx=None, generator=None):
        # as in JAX, the patch choice is random even when deterministic
        dropout = not deterministic and self.dropout > 0.0
        if (dropout and keep is None) or (
            self.frac_patches < 1.0 and patch_idx is None
        ):
            drawn_keep, drawn_idx = self.draw(fmap.shape, generator,
                                              fmap.device)
            keep = drawn_keep if keep is None else keep
            patch_idx = drawn_idx if patch_idx is None else patch_idx
        if dropout:
            fmap = torch.where(keep.to(fmap.device),
                               fmap / (1.0 - self.dropout),
                               torch.zeros((), dtype=fmap.dtype,
                                           device=fmap.device))

        if self.frac_patches < 1.0:
            p = self.patch_dim
            assert fmap.shape[1] % p == 0 and orig_image.shape[1] % p == 0
            idx = patch_idx.to(fmap.device)

            def gather(t):
                tp = _patches(t, p)
                sel = tp[torch.arange(tp.shape[0], device=t.device)[:, None],
                         idx]
                return sel.reshape(-1, *tp.shape[2:])

            fmap, orig_image = gather(fmap), gather(orig_image)

        x = self.conv_in(fmap)
        for i in range(self.depth):
            x = ops.resample.upsample_2x_blur(x)
            x = leaky_relu(getattr(self, f"conv_{i}")(x))
        diff = x.float() - orig_image.float()
        return (diff * diff).mean()


class Predictor(nn.Module):
    """Per-scale output head: 1x1 residual, a stack of 3x3 conv pairs with
    scaled residuals, 1x1 logits.  Conditional, the convs are adaptive
    convs that all share one (mod, kernel_mod) pair."""

    def __init__(self, dim: int, depth: int = 4, num_conv_kernels: int = 2,
                 unconditional: bool = False, dtype=torch.float32):
        super().__init__()
        self.depth = depth
        self.unconditional = unconditional
        self.residual_fn = conv1x1(dim, dim, dtype=dtype)
        for i in range(depth):
            for j in (1, 2):
                self.add_module(
                    f"conv{j}_{i}",
                    conv3x3(dim, dim, dtype=dtype) if unconditional
                    else AdaptiveConv(dim, dim, kernel=3,
                                      num_conv_kernels=num_conv_kernels,
                                      dtype=dtype))
        self.to_logits = conv1x1(dim, 1, dtype=dtype)

    def forward(self, x, mod=None, kernel_mod=None):
        residual = self.residual_fn(x)
        scale = 2 ** -0.5
        for i in range(self.depth):
            inner_residual = x
            for j in (1, 2):
                conv = getattr(self, f"conv{j}_{i}")
                x = leaky_relu(conv(x) if self.unconditional
                               else conv(x, mod=mod, kernel_mod=kernel_mod))
            x = (x + inner_residual) * scale
        return self.to_logits(x + residual)


class DStageCore(nn.Module):
    """One stage's residual 1x1 conv (stride 2 when the stage downsamples),
    two 3x3 convs and the optional self-attention block."""

    def __init__(self, dim_in: int, dim_out: int, downsample: bool,
                 has_attn: bool, attn_heads: int = 8, attn_dim_head: int = 64,
                 ff_mult: int = 4, dot_product: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.residual_conv = Conv(dim_in, dim_out, kernel=1,
                                  stride=2 if downsample else 1, dtype=dtype)
        self.conv_block1 = conv3x3(dim_in, dim_out, dtype=dtype)
        self.conv_block2 = conv3x3(dim_out, dim_out, dtype=dtype)
        self.attn = (
            SelfAttentionBlock(dim_out, dim_head=attn_dim_head,
                               heads=attn_heads, ff_mult=ff_mult,
                               dot_product=dot_product, dtype=dtype)
            if has_attn else None
        )

    def forward(self, x):
        residual = self.residual_conv(x)
        x = leaky_relu(self.conv_block1(x))
        x = leaky_relu(self.conv_block2(x))
        if exists(self.attn):
            x = self.attn(x)
        return x, residual


class _DStage(nn.Module):
    def __init__(self, *, resolution, has_multiscale_input, squeeze_excite,
                 from_rgb, core, predictor, recon_decoder, downsample):
        super().__init__()
        self.resolution = resolution
        self.has_multiscale_input = has_multiscale_input
        self.squeeze_excite = squeeze_excite
        self.from_rgb = from_rgb
        self.core = core
        self.predictor = predictor
        self.recon_decoder = recon_decoder
        self.downsample = downsample


class Discriminator(nn.Module):
    def __init__(
        self,
        image_size: int,
        dim_capacity: int = 16,
        dim_max: int = 2048,
        channels: int = 3,
        attn_resolutions: Tuple[int, ...] = (32, 16),
        attn_dim_head: int = 64,
        attn_heads: int = 8,
        self_attn_dot_product: bool = False,
        ff_mult: int = 4,
        text_encoder=None,
        text_dim: Optional[int] = None,
        filter_input_resolutions: bool = True,
        multiscale_input_resolutions: Tuple[int, ...] = (64, 32, 16, 8),
        multiscale_output_skip_stages: int = 1,
        aux_recon_resolutions: Tuple[int, ...] = (8,),
        aux_recon_patch_dims: Tuple[int, ...] = (2,),
        aux_recon_frac_patches: Tuple[float, ...] = (0.25,),
        aux_recon_fmap_dropout: float = 0.5,
        resize_mode: str = "bilinear",
        num_conv_kernels: int = 2,
        num_skip_layers_excite: int = 0,
        unconditional: bool = False,
        predictor_depth: int = 2,
        remat_stages: bool = False,
        s2d_trunk: bool = True,
        dtype=torch.float32,
    ):
        super().__init__()
        assert not (unconditional and exists(text_encoder))
        assert is_power_of_two(image_size)
        assert all(map(is_power_of_two, attn_resolutions))
        self.image_size = image_size
        self.channels = channels
        self.resize_mode = resize_mode
        self.num_skip_layers_excite = num_skip_layers_excite
        self.unconditional = unconditional
        self.remat_stages = remat_stages
        self.dtype = dtype

        ms_input = tuple(
            r for r in multiscale_input_resolutions
            if not filter_input_resolutions or r < image_size
        )
        assert len(set(ms_input)) == len(ms_input)
        assert all(map(is_power_of_two, ms_input))
        assert all(r < image_size for r in ms_input)
        assert multiscale_output_skip_stages > 0
        ms_output = tuple(r // (2 ** multiscale_output_skip_stages)
                          for r in ms_input)
        assert all(4 <= r < image_size for r in ms_output)
        if ms_input:
            assert max(ms_input) > max(ms_output)
            assert min(ms_input) > min(ms_output)
        self.multiscale_input_resolutions = ms_input
        self.multiscale_output_resolutions = ms_output

        assert all(map(is_power_of_two, aux_recon_resolutions))
        assert (len(aux_recon_resolutions) == len(aux_recon_patch_dims)
                == len(aux_recon_frac_patches))
        recon_patches = dict(zip(aux_recon_resolutions,
                                 zip(aux_recon_patch_dims,
                                     aux_recon_frac_patches)))

        num_layers = int(log2(image_size) - 1)
        resolutions = [image_size // (2 ** i) for i in range(num_layers)]
        dim_layers = [min(2 ** (i + 1) * dim_capacity, dim_max)
                      for i in range(num_layers)]
        dim_layers = [channels, *dim_layers]
        dim_last = dim_layers[-1]
        dim_pairs = list(zip(dim_layers[:-1], dim_layers[1:]))
        dim_kernel_mod = num_conv_kernels if num_conv_kernels > 1 else 0

        upsample_dims = []
        predictor_dims = []
        stages = []
        for ind, ((dim_in, dim_out), resolution) in enumerate(
            zip(dim_pairs, resolutions)
        ):
            is_first = ind == 0
            is_last = ind + 1 == len(dim_pairs)
            upsample_dims.insert(0, dim_in)
            squeeze_excite = None
            if (not is_first and num_skip_layers_excite > 0
                    and ind + num_skip_layers_excite < len(dim_pairs)):
                dim_skip_in, _ = dim_pairs[ind + num_skip_layers_excite]
                squeeze_excite = SqueezeExcite(dim_in, dim_skip_in,
                                               dtype=dtype)
            recon_decoder = None
            if resolution in aux_recon_resolutions:
                patch_dim, frac = recon_patches[resolution]
                recon_decoder = SimpleDecoder(
                    dim_out, tuple(upsample_dims), patch_dim=patch_dim,
                    frac_patches=frac, dropout=aux_recon_fmap_dropout,
                    dtype=dtype,
                )
            if resolution in ms_output:
                predictor_dims.extend([dim_out, dim_kernel_mod])
            stages.append(_DStage(
                resolution=resolution,
                has_multiscale_input=resolution in ms_input,
                squeeze_excite=squeeze_excite,
                from_rgb=(Conv(channels, dim_in, kernel=7, dtype=dtype)
                          if resolution in ms_input else None),
                core=DStageCore(
                    dim_in, dim_out, downsample=not is_last,
                    has_attn=resolution in attn_resolutions,
                    attn_heads=attn_heads, attn_dim_head=attn_dim_head,
                    ff_mult=ff_mult, dot_product=self_attn_dot_product,
                    dtype=dtype,
                ),
                predictor=(Predictor(dim_out, depth=predictor_depth,
                                     num_conv_kernels=num_conv_kernels,
                                     unconditional=unconditional,
                                     dtype=dtype)
                           if resolution in ms_output else None),
                recon_decoder=recon_decoder,
                downsample=(Downsample(dim_out, dim_out, dtype=dtype)
                            if not is_last else None),
            ))
        self.stages = nn.ModuleList(stages)
        self.to_logits_conv = conv3x3(dim_last, dim_last, dtype=dtype)
        self.to_logits_dense = conv1x1(dim_last * 4 * 4, 1, dtype=dtype)

        # text conditioning of the predictors: one projection of the text
        # embedding to every predictor's (mod, kernel_mod)
        assert unconditional or exists(text_dim) ^ exists(text_encoder), (
            "a conditional discriminator needs exactly one of text_dim and "
            "text_encoder")
        self.text_enc = None
        self.text_to_conv_conditioning = None
        if not unconditional:
            if isinstance(text_encoder, Mapping):
                text_encoder = TextEncoder(**text_encoder)
            self.text_enc = text_encoder
            self.predictor_dims = tuple(predictor_dims)
            self.text_to_conv_conditioning = conv1x1(
                default(text_dim, text_encoder.dim if exists(text_encoder)
                        else None),
                sum(predictor_dims), dtype=dtype)

    @property
    def recon_decoders(self):
        return [s.recon_decoder for s in self.stages
                if exists(s.recon_decoder)]

    def real_images_to_rgbs(self, images):
        """Real images resized to every multiscale input resolution."""
        return [ops.resize_image_to(images, r, self.resize_mode)
                for r in self.multiscale_input_resolutions]

    def forward(self, images, rgbs, text_encodings=None, text_embeds=None,
                return_multiscale_outputs: bool = True,
                calc_aux_loss: bool = True,
                aux_recon_samples: Optional[int] = None,
                deterministic: bool = False, recon_draws=None,
                generator=None):
        """images (b, s, s, c) and rgbs (a list holding every multiscale
        input resolution) → (logits (groups, b), multiscale logits, aux
        losses).  Conditional: CLIP ``text_encodings`` (b, n, clip_dim)
        for the text encoder, or ``text_embeds`` (b, text_dim).
        ``aux_recon_samples`` keeps the reconstruction loss to the first N
        samples (the trainer batches [real; fake] and only reals carry the
        target).  ``recon_draws``: one (keep, patch_idx) pair per
        reconstruction decoder, in stage order; without it the decoders
        draw from ``generator``."""
        conv_mods = None
        if not self.unconditional:
            assert exists(text_encodings) ^ exists(text_embeds)
            if exists(text_encodings):
                assert exists(self.text_enc)
                text_embeds = self.text_enc(text_encodings)[0]
            conv_mods = ModTable(self.text_to_conv_conditioning(text_embeds),
                                 self.predictor_dims)
        else:
            assert not exists(text_embeds) and not exists(text_encodings)
        x = images
        assert x.shape[1] == x.shape[2] == self.image_size
        batch = x.shape[0]
        rgbs_index = {t.shape[1]: t for t in rgbs} if exists(rgbs) else {}
        missing = set(self.multiscale_input_resolutions) - set(rgbs_index)
        assert not missing, (
            f"rgbs of necessary resolutions {sorted(missing)} not passed in"
        )
        draws = iter(recon_draws) if exists(recon_draws) else None

        multiscale_outputs = []
        aux_recon_losses = []
        num_groups = 1

        def rows_of_first_groups(t, keep_groups):
            t5 = t.reshape(batch, num_groups, *t.shape[1:])
            return t5[:, :keep_groups].reshape(batch * keep_groups,
                                               *t.shape[1:])

        # +1: the first stage's pixel-space input is never excited
        excitations = [None] * (self.num_skip_layers_excite + 1)
        for stage in self.stages:
            if exists(stage.squeeze_excite):
                excitations.append((stage.squeeze_excite(x), num_groups))
            entry = excitations.pop(0) if excitations else None
            if exists(entry):
                excite, excite_groups = entry
                e5 = excite.reshape(batch, excite_groups, *excite.shape[1:])
                e5 = e5.repeat(1, num_groups // excite_groups, 1, 1, 1)
                x = x * e5.reshape(batch * num_groups, *excite.shape[1:])

            groups_prev_stage = num_groups
            if stage.has_multiscale_input:
                feats = stage.from_rgb(rgbs_index[stage.resolution])
                feats = expand_batch(feats, x.shape[0])
                x = x + feats
                x5 = x.reshape(batch, num_groups, *x.shape[1:])
                f5 = feats.reshape(batch, num_groups, *x.shape[1:])
                x = torch.cat((x5, f5), dim=1).reshape(
                    batch * 2 * num_groups, *x.shape[1:])
                num_groups *= 2

            if self.remat_stages:
                x, residual = remat(stage.core, x)
            else:
                x, residual = stage.core(x)

            if exists(stage.predictor):
                mod = kernel_mod = None
                if exists(conv_mods):
                    mod, kernel_mod = conv_mods.next(), conv_mods.next()
                if return_multiscale_outputs:
                    multiscale_outputs.append(stage.predictor(
                        rows_of_first_groups(x, groups_prev_stage),
                        mod=mod, kernel_mod=kernel_mod))

            if exists(stage.downsample):
                x = stage.downsample(x)
            x = (x + residual) * (2 ** -0.5)

            if exists(stage.recon_decoder) and calc_aux_loss:
                recon_rows = rows_of_first_groups(x, 1)
                recon_target = images
                if exists(aux_recon_samples):
                    recon_rows = recon_rows[:aux_recon_samples]
                    recon_target = recon_target[:aux_recon_samples]
                keep, idx = next(draws) if exists(draws) else (None, None)
                aux_recon_losses.append(stage.recon_decoder(
                    recon_rows, recon_target, deterministic=deterministic,
                    keep=keep, patch_idx=idx, generator=generator,
                ))

        if exists(conv_mods):
            conv_mods.assert_exhausted()
        logits = self.to_logits_conv(x)
        logits = self.to_logits_dense(logits.reshape(logits.shape[0], -1))
        # (b·s,) batch-major → (s, b)
        logits = logits[..., 0].reshape(batch, -1).t()
        return logits, multiscale_outputs, aux_recon_losses
