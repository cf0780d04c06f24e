"""The reference sampler of the UNet upsampler (``train_upsampler=True``
with no discriminator): G alone, the reference's float32
``UnetUpsampler`` (``reference/unet_upsampler.py``), its weights drawn
from a seed as the port's are loaded, and ``GigaGAN.generate(lowres,
seed=s)`` followed step by step: the style latent drawn from a device
generator seeded with the second of ``np.random.SeedSequence(s)``'s two
states (the first seeds the base generator's noise, which the upsampler
has none of), the low-res image as given, the forward in IEEE float32
(``upsampler_trainer.strict_float32``).  ``latent`` is that draw alone,
which the driver holds the program's own draw to.

One departure from ``reference/unet_upsampler.py``: its full attention
runs one head at a time (``ops.attend_fused`` on each head's slice of the
fused-heads layout, the outputs concatenated in the same layout), so that
only one head's (n, n) float32 logits live at once: at a 1024² output the
two attentions at 128² (16,384 tokens) would otherwise hold 8 GiB of
logits a layer, and the softmax's copies as much again.  The products
and their sums are the same per head; under the fp8 control each head's
operands and probabilities take a scale of their own."""

from __future__ import annotations

import types

import numpy as np
import torch

from portbench.reference import numerics as nm
from portbench.reference import ops
from portbench.reference.init import init_modules
from portbench.reference.unet_upsampler import Attention2D, UnetUpsampler
from portbench.reference.upsampler_trainer import strict_float32


def _headwise_attention(self, x):
    """``Attention2D.forward`` with the attention computed head by head."""
    b, h, w, _ = x.shape
    d = self.dim_head
    q, k, v = (t.reshape(b, h * w, d * self.heads)
               for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
    out = torch.cat([
        ops.attend_fused(q[..., i * d:(i + 1) * d], k[..., i * d:(i + 1) * d],
                         v[..., i * d:(i + 1) * d], heads=1, scale=d ** -0.5)
        for i in range(self.heads)], dim=-1)
    return self.to_out(out.reshape(b, h, w, d * self.heads))


def build_models(config: dict, device) -> dict:
    """{'G'} of ``config`` (a sampler has no discriminator), float32, on
    ``device``, its full attentions head by head, every parameter and
    buffer NaN until drawn."""
    with torch.device(device):
        G = UnetUpsampler(**config["generator"])
    for m in G.modules():
        if isinstance(m, Attention2D):
            m.forward = types.MethodType(_headwise_attention, m)
    with torch.no_grad():
        for t in (*G.parameters(), *G.buffers()):
            t.fill_(float("nan"))
    return {"G": G}


def make_weights(config: dict, seed: int, device) -> dict:
    """The sampler's models of ``config`` with the weights of ``seed``: G
    drawn from one standard normal made on the device."""
    models = build_models(config, device)
    init_modules([models["G"]], seed, device)
    for key, t in models["G"].state_dict().items():
        if not torch.isfinite(t).all():
            raise RuntimeError(f"G.{key} was not drawn")
    return models


def latent(seed: int, batch: int, dim: int, device) -> torch.Tensor:
    """The style latent ``GigaGAN.generate(lowres, seed=seed)`` draws for
    ``batch`` images: (batch, dim) from a device generator seeded with the
    second of ``np.random.SeedSequence(seed)``'s two states, in the draw
    dtype (``numerics``), as float32."""
    _, s_latent = np.random.SeedSequence(seed).generate_state(2)
    gen = torch.Generator(device=device).manual_seed(int(s_latent))
    return nm.randn((batch, dim), generator=gen, device=device)


def generate(models: dict, seed: int, lowres) -> torch.Tensor:
    """G's upsampling of ``lowres`` (b, h, w, 3) in [0, 1] with ``seed``'s
    style latent, as ``GigaGAN.generate(lowres, seed=seed)`` makes it:
    (b, H, W, 3) float32 on the device."""
    G = models["G"]
    device = G.init_conv.weight.device
    x = torch.as_tensor(np.asarray(lowres), device=device).float()
    noise = latent(seed, x.shape[0], G.style_net.dim, device)
    with strict_float32():
        return G(x, noise=noise)
