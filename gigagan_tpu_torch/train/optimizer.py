"""Optimizer factory (counterpart of gigagan_tpu/train/optimizer.py): Adam,
or AdamW whose weight decay skips the parameters with ndim < 2 (biases,
norm gains, per-channel noise weights)."""

from __future__ import annotations

import torch


def get_optimizer(params, lr: float = 1e-4, wd: float = 1e-2,
                  betas=(0.9, 0.99), eps: float = 1e-8,
                  group_wd_params: bool = True):
    """The same update as the JAX package's optax Adam/AdamW: decoupled
    decay, m̂ / (√v̂ + eps)."""
    params = [p for p in params if p.requires_grad]
    if wd == 0.0:
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    if group_wd_params:
        groups = [
            {"params": [p for p in params if p.ndim >= 2]},
            {"params": [p for p in params if p.ndim < 2],
             "weight_decay": 0.0},
        ]
    else:
        groups = [{"params": params}]
    return torch.optim.AdamW(groups, lr=lr, betas=betas, eps=eps,
                             weight_decay=wd)
