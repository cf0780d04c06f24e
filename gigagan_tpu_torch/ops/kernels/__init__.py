"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

A wrapper takes its plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises.  The ops reach the wrappers through
``torch.autograd.Function``s whose structure is the same on every device,
so the CPU tests run the wiring the card runs.  ``plain_reference()``
makes the ops of the network take their plain PyTorch paths instead, on
any device — the oracle that ``chip_smoke.py`` holds a kernel-driven
forward and train step against.  Nothing on the main path enters it.
"""

from __future__ import annotations

import contextlib
import contextvars

_PLAIN: contextvars.ContextVar = contextvars.ContextVar(
    "gigagan_torch_plain_reference", default=False
)


@contextlib.contextmanager
def plain_reference():
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_kernels(t) -> bool:
    """True where the ops route a tensor to the CUDA kernels."""
    return t.is_cuda and not _PLAIN.get()


def use_fused() -> bool:
    """True where the ops go through the kernels' autograd Functions (the
    kernel on a CUDA tensor, its plain version on a CPU tensor)."""
    return not _PLAIN.get()
