"""How the reference computes: float32 throughout, or, as the control that
the benchmark's limits are set against, as an fp8 step computes: every
matrix product's and convolution's operands rounded to float8 (e4m3, one
scale per tensor), and the gradient that reaches each of them rounded to
e5m2 (one scale per tensor), so that its backward products take fp8
operands too; and in which dtype the random draws are made, so that the
reference draws the same numbers as a program that draws in bfloat16.

``numerics(draw_dtype=..., fp8=...)`` sets both for the code it wraps."""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_DRAW_DTYPE = contextvars.ContextVar("draw_dtype", default=torch.float32)
_FP8 = contextvars.ContextVar("fp8", default=False)
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def numerics(*, draw_dtype=torch.float32, fp8: bool = False):
    tokens = (_DRAW_DTYPE.set(draw_dtype), _FP8.set(fp8))
    try:
        yield
    finally:
        _DRAW_DTYPE.reset(tokens[0])
        _FP8.reset(tokens[1])


def randn(shape, *, generator=None, device=None):
    """``torch.randn`` in the draw dtype, returned as float32."""
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=_DRAW_DTYPE.get()).float()


def rand(shape, *, generator=None, device=None):
    """``torch.rand`` (float32, as the program draws it)."""
    return torch.rand(tuple(shape), generator=generator, device=device)


def _rounded(t, dtype, top):
    """``t`` rounded to ``dtype`` at one scale per tensor, with the identity
    as its derivative (to every order: the rounding is a detached offset)."""
    with torch.no_grad():
        scale = t.detach().abs().amax().float().clamp(min=1e-30) / top
        rounded = (t.detach().float() / scale).to(dtype).float() * scale
    return t + (rounded.to(t.dtype) - t.detach())


def q(t):
    """An operand of a product: itself, or under the fp8 control rounded to
    e4m3."""
    if not _FP8.get() or not t.is_floating_point():
        return t
    return _rounded(t, torch.float8_e4m3fn, E4M3_MAX)


class _GradInFp8(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to e5m2: the operand
    that the backward products of the product before it take.  The
    backward is itself differentiable (the R1 penalty's double backward
    goes through it)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return _rounded(grad, torch.float8_e5m2, E5M2_MAX)


def g(y):
    """A product's result: itself, or under the fp8 control with its
    gradient rounded to e5m2 on the way back."""
    if not _FP8.get() or not y.requires_grad:
        return y
    return _GradInFp8.apply(y)


def linear(x, w, b=None):
    return g(F.linear(q(x), q(w), b))


def conv2d(x, w, b=None, **kwargs):
    return g(F.conv2d(q(x), q(w), b, **kwargs))


def einsum(spec, *operands):
    return g(torch.einsum(spec, *(q(t) for t in operands)))


def matmul(a, b):
    return g(q(a) @ q(b))
