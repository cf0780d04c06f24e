"""Exponential moving average of the generator's parameters (counterpart
of gigagan_tpu/train/ema.py, ema_pytorch's schedule as the reference
trainer configures it): beta 0.995, update_every 10, update_after_step
100, and the warm-up ramp 1 − (1 + t)^(−2/3) clamped to beta."""

from __future__ import annotations

import torch


class EMA:
    """Holds the step counter and the ``initted`` flag of the JAX
    ``EMAState``; ``update`` lerps ``ema_model``'s parameters in place."""

    def __init__(self, ema_model: torch.nn.Module, *, beta: float = 0.995,
                 update_every: int = 10, update_after_step: int = 100,
                 inv_gamma: float = 1.0, power: float = 2.0 / 3.0,
                 min_value: float = 0.0):
        self.ema_model = ema_model
        self.beta = beta
        self.update_every = update_every
        self.update_after_step = update_after_step
        self.inv_gamma = inv_gamma
        self.power = power
        self.min_value = min_value
        self.initted = False
        self.step = 0

    def decay(self) -> float:
        """The decay of the current step: 0 (a hard copy) during warm-up
        and before the first update."""
        warm = self.step <= self.update_after_step + 1
        if warm or not self.initted:
            return 0.0
        t = max(self.step - self.update_after_step - 1, 0)
        decay = 1.0 - (1.0 + t / self.inv_gamma) ** (-self.power)
        return min(max(decay, self.min_value), self.beta)

    @torch.no_grad()
    def update(self, model: torch.nn.Module) -> None:
        self.step += 1
        should_update = self.step % self.update_every == 0
        if should_update or not self.initted:
            decay = self.decay()
            old = list(self.ema_model.parameters())
            new = [p.to(o.dtype) for p, o in zip(model.parameters(), old)]
            torch._foreach_mul_(old, decay)
            torch._foreach_add_(old, new, alpha=1.0 - decay)
        self.initted = self.initted or should_update
