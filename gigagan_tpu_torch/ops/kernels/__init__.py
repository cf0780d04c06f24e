"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

A wrapper takes its plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises.  ``plain_reference()`` makes the ops of the
network take their plain paths on the card as well — the oracle that
``chip_smoke.py`` holds a kernel-driven forward against.  Nothing on the
main path enters it.
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
