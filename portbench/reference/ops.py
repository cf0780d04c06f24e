"""The reference's operations, in plain PyTorch: the adaptive conv as
per-sample weights in one grouped conv, attention as two products and a
softmax, resampling through ``F.interpolate`` and a reflect-padded
binomial blur.  Channels-last maps (b, h, w, c); kernel banks
(n, kh, kw, in, out)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import numerics as nm
from portbench.reference.utils import exists


def expand_batch(t, batch: int):
    """Repeat each row to match an expanded batch (batch-major groups)."""
    if t.shape[0] == batch:
        return t
    s, rem = divmod(batch, t.shape[0])
    assert rem == 0, f"cannot expand batch {t.shape[0]} to {batch}"
    return torch.repeat_interleave(t, s, dim=0)


def adaptive_conv(x, weights, mod, kernel_mod=None, *, demod: bool = True,
                  eps: float = 1e-8):
    """StyleGAN2's modulated conv with a per-sample softmax mix of the
    kernel banks: w_b = Σₙ aₙ Wₙ · (1 + mod_b) on the input channels,
    demodulated over each output channel, SAME-padded, stride 1."""
    b, h, w_, ci = x.shape
    n, kh, kw, _, co = weights.shape
    mod = expand_batch(mod, b)
    if n > 1:
        attn = torch.softmax(expand_batch(kernel_mod, b).float(), dim=-1)
        w = torch.einsum("bn,nhwio->bhwio", attn, weights)
    else:
        w = weights[0].expand(b, kh, kw, ci, co)
    w = w * (mod + 1.0)[:, None, None, :, None]
    if demod:
        sq = (w * w).sum(dim=(1, 2, 3), keepdim=True)
        w = w * torch.rsqrt(torch.clamp(sq, min=eps))
    # (b, kh, kw, i, o) → (b·o, i, kh, kw), one group per sample
    wg = w.permute(0, 4, 3, 1, 2).reshape(b * co, ci, kh, kw)
    xg = x.permute(0, 3, 1, 2).reshape(1, b * ci, h, w_)
    out = nm.conv2d(xg, wg, padding=kh // 2, groups=b)
    return out.reshape(b, co, h, w_).permute(0, 2, 3, 1)


NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attend(q, k, v, *, mask=None, l2_dist: bool = False, scale=None):
    """Softmax attention, q (b, h, i, d), k/v (b, h, j, d), an optional
    (b, j) key mask (True attends).  The L2 similarity is −scale·|q − k|²
    without its |q|² term, which is constant along a row."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sim = nm.einsum("bhid,bhjd->bhij", q, k)
    if l2_dist:
        sim = 2.0 * scale * sim - scale * (k * k).sum(-1)[..., None, :]
    else:
        sim = scale * sim
    if exists(mask):
        sim = sim.masked_fill(~mask[:, None, None, :], NEG_INF)
    return nm.einsum("bhij,bhjd->bhid", sim.softmax(dim=-1), v)


def attend_fused(q, k, v, *, heads: int, null_kv=None, l2_dist: bool = False,
                 scale=None):
    """Attention in the fused-heads layout: q (b, nq, H·d), k/v
    (b, nk, H·d), a learned null key/value (2, H, d) in front of the
    keys."""
    b, nq, hd = q.shape
    nk, d = k.shape[1], hd // heads

    def split(t, n):
        return t.reshape(b, n, heads, d).permute(0, 2, 1, 3)

    qh, kh, vh = split(q, nq), split(k, nk), split(v, nk)
    if exists(null_kv):
        kh = torch.cat((null_kv[0][None, :, None].expand(b, heads, 1, d), kh),
                       dim=-2)
        vh = torch.cat((null_kv[1][None, :, None].expand(b, heads, 1, d), vh),
                       dim=-2)
    out = attend(qh, kh, vh, l2_dist=l2_dist, scale=scale)
    return out.permute(0, 2, 1, 3).reshape(b, nq, hd)


def _channels_first(x):
    return x.permute(0, 3, 1, 2)


def _channels_last(x):
    return x.permute(0, 2, 3, 1)


def blur_2d(x):
    """Normalised binomial [1,2,1]⊗[1,2,1] blur, reflect-padded."""
    f = torch.tensor([1.0, 2.0, 1.0], device=x.device)
    f = (f[:, None] * f[None, :]) / 16.0
    c = x.shape[-1]
    xc = F.pad(_channels_first(x), (1, 1, 1, 1), mode="reflect")
    return _channels_last(F.conv2d(xc, f.expand(c, 1, 3, 3), groups=c))


def upsample_2x(x):
    """Bilinear 2x, half-pixel centres."""
    return _channels_last(F.interpolate(_channels_first(x), scale_factor=2,
                                        mode="bilinear",
                                        align_corners=False))


def upsample_2x_blur(x):
    return blur_2d(upsample_2x(x))


def resize_image_to(images, size: int, method: str = "bilinear"):
    """Resize (b, h, w, c) to size × size: bilinear without antialiasing,
    or nearest (torch's legacy floor index)."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    if method in ("bilinear", "linear"):
        out = F.interpolate(_channels_first(images), size=(size, size),
                            mode="bilinear", align_corners=False)
    elif method == "nearest":
        out = F.interpolate(_channels_first(images), size=(size, size),
                            mode="nearest")
    else:
        raise NotImplementedError(method)
    return _channels_last(out)
