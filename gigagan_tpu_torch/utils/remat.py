"""Recomputation in the backward (counterpart of ``jax.checkpoint`` /
``nn.remat`` in the JAX package) over ``torch.utils.checkpoint``."""

from __future__ import annotations

import contextlib
import contextvars

from torch.utils.checkpoint import checkpoint


class _AsInTheForward:
    """The context of every recomputation of one checkpointed call (it may
    run more than once: once per backward that reaches it): the context
    variables and the generators' states of the forward's start, each
    generator left where it was found."""

    def __init__(self, generators):
        self.ctx = contextvars.copy_context()
        self.gens = [g for g in generators if g is not None]
        self.start = [g.get_state() for g in self.gens]
        self.entered = []  # (tokens, generator states found), innermost last

    def __enter__(self):
        tokens = [(var, var.set(value)) for var, value in self.ctx.items()]
        self.entered.append((tokens, [g.get_state() for g in self.gens]))
        for g, state in zip(self.gens, self.start):
            g.set_state(state)

    def __exit__(self, *exc):
        tokens, found = self.entered.pop()
        for g, state in zip(self.gens, found):
            g.set_state(state)
        for var, token in reversed(tokens):
            var.reset(token)
        return False


def remat(fn, *args, generators=()):
    """``fn(*args)``, its saved activations dropped and recomputed in the
    backward (non-reentrant checkpoint).  The recomputation sees what the
    forward saw: the context variables (``plain_reference()``, the
    attention modes), which the autograd engine's device threads do not
    inherit, and the states of the explicit ``generators`` at the
    forward's start, so that it draws the same noise again."""
    return checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _AsInTheForward(generators)))
