"""Blur / resample primitives, channels-last (counterpart of
gigagan_tpu/ops/resample.py: ``blur_2d``, ``upsample_2x``,
``upsample_2x_blur``, ``pixel_shuffle``, ``resize_image_to``).

Feature maps are ``(b, h, w, c)``; torch's spatial ops want ``(b, c, h, w)``,
so each op works on a permuted view and permutes back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BINOMIAL = (1.0, 2.0, 1.0)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def blur_2d(x):
    """Normalized binomial [1,2,1]⊗[1,2,1] blur on (b, h, w, c) with
    reflect padding (kornia ``filter2d``'s default border, as in JAX)."""
    c = x.shape[-1]
    f = torch.tensor(_BINOMIAL, dtype=torch.float32, device=x.device)
    f = f[:, None] * f[None, :]
    f = (f / f.sum()).to(x.dtype)
    xp = F.pad(_nchw(x), (1, 1, 1, 1), mode="reflect")
    kern = f.expand(c, 1, 3, 3)
    return _nhwc(F.conv2d(xp, kern, groups=c))


def upsample_2x(x):
    """Bilinear 2x upsample with half-pixel centers (``align_corners=False``)
    — the same samples as ``jax.image.resize(..., 'bilinear')`` gives when
    upsampling, edges included."""
    return _nhwc(
        F.interpolate(_nchw(x), scale_factor=2, mode="bilinear",
                      align_corners=False)
    )


def upsample_2x_blur(x):
    """The reference Upsample: bilinear 2x then binomial blur."""
    return blur_2d(upsample_2x(x))


def pixel_shuffle(x, r: int = 2):
    """(b, h, w, c·r²) → (b, h·r, w·r, c) with torch ``PixelShuffle``'s
    channel order (c, r1, r2)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def resize_image_to(images, size: int, method: str = "bilinear"):
    """Resize (b, h, w, c) so that h == w == size with torch
    ``F.interpolate`` semantics, which the JAX package reproduces by hand:
    'bilinear' is align_corners=False without antialiasing, 'nearest' the
    legacy floor(i·in/out) source index."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    if method in ("bilinear", "linear"):
        out = F.interpolate(_nchw(images), size=(size, size),
                            mode="bilinear", align_corners=False,
                            antialias=False)
    elif method == "nearest":
        out = F.interpolate(_nchw(images), size=(size, size), mode="nearest")
    else:
        raise NotImplementedError(
            f"resize_image_to: method {method!r} is not ported (bilinear "
            "and nearest are)"
        )
    return _nhwc(out)
