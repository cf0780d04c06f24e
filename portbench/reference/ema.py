"""The reference's EMA of G: a copy of the port's schedule
(``gigagan_tpu_torch/train/ema.py``): beta 0.995, an update every 10th
step after a hard copy at the first, warm-up ramp 1 − (1 + t)^(−2/3)."""

from __future__ import annotations

import torch


class EMA:
    def __init__(self, ema_model, *, beta: float = 0.995,
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
        warm = self.step <= self.update_after_step + 1
        if warm or not self.initted:
            return 0.0
        t = max(self.step - self.update_after_step - 1, 0)
        decay = 1.0 - (1.0 + t / self.inv_gamma) ** (-self.power)
        return min(max(decay, self.min_value), self.beta)

    @torch.no_grad()
    def update(self, model) -> None:
        self.step += 1
        should_update = self.step % self.update_every == 0
        if should_update or not self.initted:
            decay = self.decay()
            for old, new in zip(self.ema_model.parameters(),
                                model.parameters()):
                old.mul_(decay).add_(new, alpha=1.0 - decay)
        self.initted = self.initted or should_update
