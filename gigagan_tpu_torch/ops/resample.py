"""Blur / resample primitives, channels-last (counterpart of
gigagan_tpu/ops/resample.py: ``blur_2d``, ``blur_3d``, ``blur_temporal``,
``upsample_2x``, ``upsample_2x_blur``, ``pixel_shuffle``,
``pixel_shuffle_temporal``, ``downsample_hf_shuttle``, ``resize_image_to``
and ``interpolate_1d``).

Feature maps are ``(b, *spatial, c)``; torch's spatial ops want the
channels first, so each op works on a permuted view and permutes back.

Every op here has a backward without float atomics, so that a train step
repeats bitwise on the card:

- the blurs' reflect padding is slices and a concatenation, not
  ``F.pad(mode="reflect")``, whose CUDA backward scatters with atomics;
- the linear resizes (``upsample_2x``, bilinear ``resize_image_to``,
  ``interpolate_1d``) multiply by a fixed interpolation matrix per axis,
  which holds exactly torch's ``align_corners=False`` taps (a matmul's
  backward is a matmul), instead of ``F.interpolate``, whose CUDA backward
  scatters with atomics; the products run in fp32, as ``F.interpolate``
  computes in fp32 for bf16 inputs.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from gigagan_tpu_torch.utils import span

_BINOMIAL = (1.0, 2.0, 1.0)


def _channels_first(x):
    return x.movedim(-1, 1)


def _channels_last(x):
    return x.movedim(1, -1)


def _reflect_pad1(x, axis: int):
    """Reflect-pad ``axis`` by one on each side (numpy's 'reflect': the
    border row is not repeated; a length-1 axis repeats its one row), as
    slices and a concatenation."""
    n = x.shape[axis]
    lo = x.narrow(axis, 1 if n > 1 else 0, 1)
    hi = x.narrow(axis, n - 2 if n > 1 else 0, 1)
    return torch.cat((lo, x, hi), dim=axis)


def _depthwise(x, kernel):
    """x (b, *spatial, c) blurred per channel by ``kernel`` (*k) of odd
    sizes 3 in x's dtype, reflect-padded (kornia ``filter2d``/``filter3d``'s
    default border, as in JAX)."""
    rank = kernel.dim()
    c = x.shape[-1]
    for axis in range(1, 1 + rank):
        x = _reflect_pad1(x, axis)
    kern = kernel.expand(c, 1, *kernel.shape)
    conv = F.conv2d if rank == 2 else F.conv3d
    return _channels_last(conv(_channels_first(x), kern, groups=c))


@functools.lru_cache(maxsize=None)
def _blur_filter(kind: str, device, dtype):
    """The normalised blur filter of ``kind`` ('2d', '3d' or 'temporal') in
    ``dtype`` on ``device``, kept (a read-only operand), so that a blur
    copies nothing to the card and launches only its conv; made in fp32 and
    then cast, as each blur made it before it was kept, and outside
    inference mode, so that a filter first made while sampling can be saved
    for a later backward."""
    with span("gigagan.sync.blur_kernel"), torch.inference_mode(False):
        f = torch.tensor(_BINOMIAL, dtype=torch.float32, device=device)
        if kind == "2d":
            f = f[:, None] * f[None, :]
        elif kind == "3d":
            f = f[:, None, None] * f[None, :, None] * f[None, None, :]
        else:
            f = f[:, None, None].expand(3, 3, 3)
        return (f / f.sum()).to(dtype)


def blur_2d(x):
    """Normalized binomial [1,2,1]⊗[1,2,1] blur on (b, h, w, c)."""
    return _depthwise(x, _blur_filter("2d", x.device, x.dtype))


def blur_3d(x):
    """Normalized separable binomial blur on (b, t, h, w, c)."""
    return _depthwise(x, _blur_filter("3d", x.device, x.dtype))


def blur_temporal(x):
    """The temporal blur of the video upsample on (b, t, h, w, c): [1,2,1]
    along time, a box over the 3x3 spatial window, normalized."""
    return _depthwise(x, _blur_filter("temporal", x.device, x.dtype))


def _linear_taps(in_size: int, out_size: int):
    """(out, in) float64 matrix of torch's linear interpolation with
    ``align_corners=False`` and no antialiasing: output i reads source
    coordinate max(0, (i + 0.5)·in/out − 0.5) as two taps, clamped at the
    edge."""
    i = torch.arange(out_size, dtype=torch.float64)
    src = ((i + 0.5) * (in_size / out_size) - 0.5).clamp(min=0.0)
    lo = src.floor().long().clamp(max=in_size - 1)
    hi = (lo + 1).clamp(max=in_size - 1)
    w = src - lo
    m = torch.zeros(out_size, in_size, dtype=torch.float64)
    rows = torch.arange(out_size)
    m.index_put_((rows, lo), 1.0 - w, accumulate=True)
    m.index_put_((rows, hi), w, accumulate=True)
    return m


def _antialias_taps(in_size: int, out_size: int):
    """(out, in) float64 matrix of ``jax.image.resize(..., 'bilinear')``
    (antialias on): a triangle kernel widened by the downsampling factor,
    its weights normalized over the input, zero for samples outside it."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float64) + 0.5) \
        * inv_scale - 0.5
    dist = (sample[:, None] - torch.arange(in_size, dtype=torch.float64)
            [None, :]).abs() / kernel_scale
    w = (1.0 - dist).clamp(min=0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


@functools.lru_cache(maxsize=128)
def _matrix(taps, in_size: int, out_size: int, device):
    """``taps(in, out)`` in fp32 on ``device``, kept (a read-only operand),
    so that a forward copies no matrix to the card; made outside inference
    mode, so that a matrix first made while sampling can be saved for a
    later backward."""
    with torch.inference_mode(False):
        return taps(in_size, out_size).to(device=device,
                                          dtype=torch.float32)


def _resample(x, sizes, taps):
    """x resampled to ``sizes`` ({axis: size}) by the (out, in) matrices
    ``taps(in, out)``, one axis after another in fp32, rounded to x's
    dtype once at the end (as ``F.interpolate`` rounds a bf16 output
    once)."""
    if all(x.shape[axis] == out_size for axis, out_size in sizes.items()):
        return x
    y = x.float()
    for axis, out_size in sizes.items():
        axis = axis % y.dim()
        in_size = y.shape[axis]
        if in_size == out_size:
            continue
        pre = 1
        for s in y.shape[:axis]:
            pre *= s
        post = 1
        for s in y.shape[axis + 1:]:
            post *= s
        m = _matrix(taps, in_size, out_size, y.device)
        z = torch.matmul(m, y.reshape(pre, in_size, post))
        y = z.reshape(*y.shape[:axis], out_size, *y.shape[axis + 1:])
    return y.to(x.dtype)


def _nearest_axis(x, out_size: int, axis: int):
    """torch ``F.interpolate(mode='nearest')`` along ``axis``: the legacy
    floor(i·in/out) source index."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    idx = torch.floor(torch.arange(out_size, dtype=torch.float64)
                      * (in_size / out_size)).long().clamp(max=in_size - 1)
    with span("gigagan.sync.resize_index"):
        idx = idx.to(x.device)
    return x.index_select(axis, idx)


def upsample_2x(x):
    """Bilinear 2x upsample of the two axes before the channel axis with
    half-pixel centers (``align_corners=False``): the same samples as
    ``jax.image.resize(..., 'bilinear')`` gives when upsampling, edges
    included."""
    h_ax, w_ax = x.dim() - 3, x.dim() - 2
    return _resample(x, {h_ax: 2 * x.shape[h_ax], w_ax: 2 * x.shape[w_ax]},
                     _linear_taps)


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


def pixel_shuffle_temporal(x, r: int = 2):
    """(b, t, h, w, c·r) → (b, t·r, h, w, c), the channel order (c, p) of
    the reference's Rearrange('b (c p) t h w -> b c (t p) h w')."""
    b, t, h, w, cr = x.shape
    c = cr // r
    x = x.reshape(b, t, h, w, c, r).permute(0, 1, 5, 2, 3, 4)
    return x.reshape(b, t * r, h, w, c)


def downsample_hf_shuttle(x, *, is_video: bool, skip_downsample: bool):
    """blur → high-frequency residual → 2x max pool (time too for video).

    The input has already been conv-projected by the caller.  Returns
    (downsampled, hf residual); with ``skip_downsample``, x and an empty
    ``x[..., 0:0]``.  The max pool's gradient goes to one element of each
    window, as the gradient of JAX's ``reduce_window`` max does."""
    if skip_downsample:
        return x, x[..., 0:0]
    blurred = blur_3d(x) if is_video else blur_2d(x)
    hf = x - blurred
    pool = F.max_pool3d if is_video else F.max_pool2d
    pooled = _channels_last(pool(_channels_first(x), 2, 2))
    return pooled, hf


def resize_image_to(images, size: int, method: str = "bilinear"):
    """Resize (b, ..., h, w, c) so that h == w == size.

    - 'bilinear': torch ``F.interpolate`` with align_corners=False and no
      antialiasing (the reference's multiscale reals and skip resizes);
    - 'nearest': torch's default ``F.interpolate`` mode, the legacy
      floor(i·in/out) source index (the upsampler's low-res conditioning
      and sample grids);
    - 'antialias': ``jax.image.resize(..., 'bilinear')``, which widens its
      kernel when downsampling."""
    sizes = {images.dim() - 3: size, images.dim() - 2: size}
    if method in ("bilinear", "linear"):
        return _resample(images, sizes, _linear_taps)
    if method in ("antialias", "bilinear_antialias"):
        return _resample(images, sizes, _antialias_taps)
    if method == "nearest":
        for ax in sizes:
            images = _nearest_axis(images, size, ax)
        return images
    raise NotImplementedError(
        f"resize_image_to: method {method!r} is not ported (bilinear, "
        "nearest and antialias are)")


def interpolate_1d(x, length: int, method: str = "linear"):
    """(b, t, c) → (b, length, c) linear interpolation with torch
    ``F.interpolate`` semantics (align_corners=False)."""
    if method != "linear":
        raise NotImplementedError(
            f"interpolate_1d: method {method!r} is not ported (linear is)")
    return _resample(x, {1: length}, _linear_taps)
