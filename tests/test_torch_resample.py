"""The port's resample ops (``gigagan_tpu_torch/ops/resample.py``) against
the JAX package's on the CPU: every op's fp32 values, and the gradients of
the deterministic forms (interpolation matrices, reflect padding by
slices) against those of ``F.interpolate`` and ``F.pad``, which they
replace because their CUDA backwards sum with float atomics.

Tolerances: fp32 values and gradients within 1e-6 relative to the largest
magnitude (a few fp32 roundings of sums of at most 27 terms)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from gigagan_tpu.ops import resample as jr  # noqa: E402

from gigagan_tpu_torch.ops import resample as tr  # noqa: E402

REL = 1e-6


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.size:
        err = np.abs(got - want).max()
        assert err <= REL * (np.abs(want).max() + 1e-30), (what, err)


def rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


IMAGE, VIDEO = (2, 12, 10, 3), (2, 4, 12, 10, 3)


@pytest.mark.parametrize("name,shape", [
    ("blur_2d", IMAGE), ("blur_3d", VIDEO), ("blur_temporal", VIDEO),
    ("upsample_2x", IMAGE), ("upsample_2x", VIDEO),
    ("upsample_2x_blur", IMAGE), ("blur_3d", (1, 1, 5, 6, 2)),
], ids=["blur_2d", "blur_3d", "blur_temporal", "upsample_2x",
        "upsample_2x_video", "upsample_2x_blur", "blur_3d_one_frame"])
def test_elementwise_ops_match_jax(name, shape):
    # a one-frame clip: the reflect pad of a length-1 axis repeats its row
    # (numpy's 'reflect'), as the video path's last pooled stages give it
    x = rand(shape, 1)
    close(getattr(tr, name)(t(x)), getattr(jr, name)(jnp.asarray(x)), name)


def test_pixel_shuffle_temporal_matches_jax():
    x = rand((2, 3, 4, 5, 6), 2)
    np.testing.assert_array_equal(
        tr.pixel_shuffle_temporal(t(x), 2).numpy(),
        np.asarray(jr.pixel_shuffle_temporal(jnp.asarray(x), 2)))


@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
@pytest.mark.parametrize("skip", [False, True], ids=["pool", "skip"])
def test_hf_shuttle_matches_jax(video, skip):
    x = rand(VIDEO if video else IMAGE, 3)
    got = tr.downsample_hf_shuttle(t(x), is_video=video, skip_downsample=skip)
    want = jr.downsample_hf_shuttle(jnp.asarray(x), is_video=video,
                                    skip_downsample=skip)
    for g, w, what in zip(got, want, ("pooled", "hf")):
        close(g, w, what)
    if skip:
        assert got[1].shape[-1] == 0


def test_hf_shuttle_max_pool_gradient_goes_to_one_element():
    # on a tie JAX's reduce_window max sends the whole gradient to one
    # element of the window, as F.max_pool2d does; an amax would split it
    import jax

    x = np.zeros((1, 4, 4, 1), np.float32)
    want = jax.grad(lambda a: jr.downsample_hf_shuttle(
        a, is_video=False, skip_downsample=False)[0].sum())(jnp.asarray(x))
    xt = t(x).requires_grad_()
    tr.downsample_hf_shuttle(xt, is_video=False,
                             skip_downsample=False)[0].sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert xt.grad.sum() == 4 and xt.grad.max() == 1


RESIZES = [("bilinear", 24), ("bilinear", 6), ("bilinear", 7),
           ("nearest", 24), ("nearest", 5), ("antialias", 24),
           ("antialias", 5), ("antialias", 4)]


@pytest.mark.parametrize("method,size", RESIZES,
                         ids=[f"{m}-{s}" for m, s in RESIZES])
@pytest.mark.parametrize("rank", [4, 5], ids=["image", "video"])
def test_resize_image_to_matches_jax(method, size, rank):
    # up, down and non-integer ratios on square and non-square maps, of
    # (b, h, w, c) and (b, t, h, w, c)
    x = rand(IMAGE if rank == 4 else VIDEO, 4)
    close(tr.resize_image_to(t(x), size, method),
          jr.resize_image_to(jnp.asarray(x), size, method), method)


@pytest.mark.parametrize("length", [8, 2, 3, 4], ids=["up", "down",
                                                      "non_integer", "same"])
def test_interpolate_1d_matches_jax(length):
    x = rand((3, 4, 5), 5)
    close(tr.interpolate_1d(t(x), length),
          jr.interpolate_1d(jnp.asarray(x), length), "interpolate_1d")


def grads(fn, x, cot):
    xt = t(x).requires_grad_()
    (fn(xt) * t(cot)).sum().backward()
    return xt.grad.numpy()


def nchw(fn):
    """An NCHW torch op applied to a (b, h, w, c) map."""
    return lambda x: fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("size", [24, 6, 7], ids=["up", "down",
                                                  "non_integer"])
def test_bilinear_resize_gradient_matches_f_interpolate(size):
    x, cot = rand(IMAGE, 6), rand((2, size, size, 3), 7)
    want_fn = nchw(lambda y: F.interpolate(
        y, size=(size, size), mode="bilinear", align_corners=False,
        antialias=False))
    close(tr.resize_image_to(t(x), size), want_fn(t(x)), "values")
    close(grads(lambda y: tr.resize_image_to(y, size), x, cot),
          grads(want_fn, x, cot), "gradient")


def test_upsample_2x_gradient_matches_f_interpolate():
    x, cot = rand(IMAGE, 8), rand((2, 24, 20, 3), 9)
    want_fn = nchw(lambda y: F.interpolate(
        y, scale_factor=2, mode="bilinear", align_corners=False))
    close(tr.upsample_2x(t(x)), want_fn(t(x)), "values")
    close(grads(tr.upsample_2x, x, cot), grads(want_fn, x, cot), "gradient")


def test_interpolate_1d_gradient_matches_f_interpolate():
    x, cot = rand((3, 4, 5), 10), rand((3, 8, 5), 11)

    def want_fn(y):
        return F.interpolate(y.transpose(1, 2), size=8, mode="linear",
                             align_corners=False).transpose(1, 2)

    close(grads(lambda y: tr.interpolate_1d(y, 8), x, cot),
          grads(want_fn, x, cot), "gradient")


def test_blur_2d_gradient_matches_f_pad_reflect():
    x, cot = rand(IMAGE, 12), rand(IMAGE, 13)
    f = torch.tensor([1.0, 2.0, 1.0])
    kern = (f[:, None] * f[None, :] / 16.0).expand(3, 1, 3, 3)

    def want_fn(y):
        return nchw(lambda z: F.conv2d(F.pad(z, (1, 1, 1, 1),
                                             mode="reflect"), kern,
                                       groups=3))(y)

    close(tr.blur_2d(t(x)), want_fn(t(x)), "values")
    close(grads(tr.blur_2d, x, cot), grads(want_fn, x, cot), "gradient")


# backward nodes whose CUDA kernels sum with float atomics
ATOMIC_NODES = ("Upsample", "ReflectionPad", "IndexAddBackward",
                "IndexPutBackward")


def backward_nodes(out):
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


@pytest.mark.parametrize("name", [
    "upsample_2x_blur", "resize_bilinear", "resize_antialias", "blur_3d",
    "blur_temporal", "interpolate_1d", "hf_shuttle"])
def test_backward_has_no_atomic_op(name):
    # the train step's resample ops differentiate through matmuls, slices,
    # concatenations and depthwise convs only
    x = t(rand(VIDEO if name.startswith(("blur_", "hf")) else IMAGE, 14))
    x.requires_grad_()
    out = {
        "upsample_2x_blur": lambda: tr.upsample_2x_blur(x),
        "resize_bilinear": lambda: tr.resize_image_to(x, 20),
        "resize_antialias": lambda: tr.resize_image_to(x, 5, "antialias"),
        "blur_3d": lambda: tr.blur_3d(x),
        "blur_temporal": lambda: tr.blur_temporal(x),
        "interpolate_1d": lambda: tr.interpolate_1d(x[:, 0], 9),
        "hf_shuttle": lambda: sum(o.sum() for o in tr.downsample_hf_shuttle(
            x, is_video=True, skip_downsample=False)),
    }[name]()
    nodes = backward_nodes(out)
    assert not [n for n in nodes if n.startswith(ATOMIC_NODES)], nodes


def test_a_matrix_made_while_sampling_serves_a_later_backward():
    # the interpolation matrices are kept per device; one first made under
    # inference mode (sampling) must still be savable for a backward
    tr._matrix.cache_clear()
    x = t(rand(IMAGE, 15))
    with torch.inference_mode():
        tr.upsample_2x(x)
        tr.resize_image_to(x, 5, "antialias")
    x.requires_grad_()
    (tr.upsample_2x(x).sum() + tr.resize_image_to(x, 5, "antialias").sum()
     ).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
