"""Two of the upsampler's G layers checked call by call against the
reference's plain float32 functions, at the shapes, dtypes and autocast
state the run gave them: the adaptive convolution (``ops.adaptive_conv``:
K1 forward; K2 and the data gradient backward, on the card) and the
linear attention (``ops.linear_attend_fused``, which a fused kernel is to
replace).  The whole step's numbers cannot see a fault in G's backward in
this configuration: D's first Adam step makes D sharp enough that G's
first gradient through it spreads by rounding as widely in bf16 as in the
fp8 control.  A layer alone has no such amplifier.

``Calls`` records the distinct calls of a run (the program's, or the
reference's for the control).  ``gaps`` replays each on seeded operands
and a seeded output gradient, through the implementation under test and
through the float32 reference (``reference.ops.adaptive_conv``,
``reference.unet_upsampler.linear_attend`` in IEEE float32): per result
(the output, each operand's gradient) ‖got − want‖ / ‖want‖, and per
layer the worst, ``aconv_gap`` and ``linattn_gap``."""

from __future__ import annotations

import contextlib

import torch

from portbench.reference import numerics as nm
from portbench.reference import ops as ref_ops
from portbench.reference import unet_upsampler as ref_unet
from portbench.reference.upsampler_trainer import strict_float32

LAYERS = ("aconv", "linattn")


def _autocast_state(device_type: str):
    if not torch.is_autocast_enabled(device_type):
        return None
    return torch.get_autocast_dtype(device_type)


def _spec(t):
    return None if t is None else (tuple(t.shape), t.dtype)


class Calls:
    """While open, the distinct calls of the two layers (by the operands'
    shapes and dtypes, the options and the autocast state), through the
    program's entries, or with ``reference=True`` through the
    reference's."""

    def __init__(self, *, reference: bool = False):
        self.reference = reference
        self.seen = {"aconv": {}, "linattn": {}}
        self._saved = []

    def _targets(self):
        if self.reference:
            return ((ref_ops, "adaptive_conv", "aconv"),
                    (ref_unet, "linear_attend", "linattn"))
        from gigagan_tpu_torch import ops

        return ((ops, "adaptive_conv", "aconv"),
                (ops, "linear_attend_fused", "linattn"))

    def __enter__(self):
        for module, name, layer in self._targets():
            original = getattr(module, name)
            setattr(module, name, self._recording(layer, original))
            self._saved.append((module, name, original))
        return self

    def _recording(self, layer, original):
        seen = self.seen[layer]

        def entry(*args, **kwargs):
            if layer == "aconv":
                x, weights, mod = args[:3]
                kernel_mod = args[3] if len(args) > 3 else \
                    kwargs.get("kernel_mod")
                plain = (kwargs.get("stride", 1) == 1
                         and kwargs.get("dilation", 1) == 1
                         and x.dim() == 4)
                key = (_spec(x), _spec(weights), _spec(mod),
                       _spec(kernel_mod), kwargs.get("demod", True),
                       _autocast_state(x.device.type), x.device)
                if plain:
                    seen.setdefault(key, None)
            else:
                q, k, v = args[:3]
                key = (_spec(q), k.dtype, v.dtype, kwargs["heads"],
                       kwargs.get("scale"), _autocast_state(q.device.type),
                       q.device)
                seen.setdefault(key, None)
            return original(*args, **kwargs)

        return entry

    def __exit__(self, *exc):
        for module, name, original in reversed(self._saved):
            setattr(module, name, original)
        self._saved = []
        return False


def _draw(gen, spec, device, scale=1.0):
    shape, dtype = spec
    t = torch.randn(shape, generator=gen, device=device) * scale
    return t.to(dtype)


def _aconv_operands(key, gen):
    x, w, mod, kmod, demod, cast, device = key
    ci = w[0][3]
    return [_draw(gen, x, device), _draw(gen, w, device, (9 * ci) ** -0.5),
            _draw(gen, mod, device, 0.1),
            None if kmod is None else _draw(gen, kmod, device)], demod


def _linattn_operands(key, gen):
    q, k_dtype, v_dtype, heads, scale, cast, device = key
    shape = q[0]
    return [_draw(gen, q, device), _draw(gen, (shape, k_dtype), device),
            _draw(gen, (shape, v_dtype), device)], heads, scale


def _aconv_fns(program_fn, demod):
    def prog(x, w, mod, kernel_mod):
        return program_fn(x, w, mod, kernel_mod, demod=demod)

    def ref(x, w, mod, kernel_mod):
        return ref_ops.adaptive_conv(x, w, mod, kernel_mod, demod=demod)

    return prog, ref


def _linattn_fns(program_fn, heads, scale):
    def prog(q, k, v):
        return program_fn(q, k, v, heads=heads, scale=scale)

    def ref(q, k, v):
        d = q.shape[-1] // heads
        return ref_unet.linear_attend(
            q, k, v, heads=heads, scale=d ** -0.5 if scale is None else scale)

    return prog, ref


def _results(fn, operands, cast, device, out_grad_seed):
    """fn's output and each operand's gradient, float32."""
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in operands]
    with contextlib.ExitStack() as stack:
        if cast is not None:
            stack.enter_context(torch.autocast(device.type, dtype=cast))
        out = fn(*leaves)
    gen = torch.Generator(device=device).manual_seed(out_grad_seed)
    dout = torch.randn(out.shape, generator=gen, device=device).to(out.dtype)
    inputs = [t for t in leaves if t is not None]
    grads = torch.autograd.grad(out, inputs, dout)
    return [out.detach().float()] + [g.float() for g in grads]


def _gap(got, want) -> float:
    if got.shape != want.shape or not torch.isfinite(got).all():
        return float("inf")
    scale = want.norm()
    return float((got - want).norm() / scale) if scale > 0 else (
        0.0 if torch.equal(got, want) else float("inf"))


def gaps(calls: Calls, seed: int, *, under_test: str) -> dict:
    """``aconv_gap`` and ``linattn_gap`` of the calls recorded: the
    program's entries (``under_test='program'``) or the reference in fp8
    (``'fp8'``, the control), each against the reference in float32."""
    from gigagan_tpu_torch import ops

    out = {}
    for layer in LAYERS:
        worst = 0.0
        for i, key in enumerate(calls.seen[layer]):
            device = key[-1]
            cast = key[-2]
            gen = torch.Generator(device=device).manual_seed(seed + i)
            if layer == "aconv":
                operands, demod = _aconv_operands(key, gen)
                prog, ref = _aconv_fns(ops.adaptive_conv, demod)
            else:
                operands, heads, scale = _linattn_operands(key, gen)
                prog, ref = _linattn_fns(ops.linear_attend_fused, heads,
                                         scale)
            as_f32 = [None if t is None else t.float() for t in operands]
            with strict_float32(), nm.numerics():
                want = _results(ref, as_f32, None, device, seed + i)
            if under_test == "program":
                got = _results(prog, operands, cast, device, seed + i)
            else:
                with strict_float32(), nm.numerics(fp8=True):
                    got = _results(ref, as_f32, None, device, seed + i)
            worst = max([worst] + [_gap(g, w) for g, w in zip(got, want)])
            del got, want, operands, as_f32
        out[f"{layer}_gap"] = worst if calls.seen[layer] else float("inf")
    return out
