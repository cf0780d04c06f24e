"""Weight bridge: a JAX parameter tree (the generator's, the
discriminator's, or any of their layers') → the state_dict of this
package's twin module.

Input: the flax ``params`` tree as nested mappings of arrays (for example
``jax.device_get(params)``; anything ``np.asarray`` accepts).  Naming and
layout map as follows:

- ``stages_{s}_{name}/...``   → ``stages.{s}.{name}....``
- Dense ``kernel`` (in, out)  → Linear ``weight`` (out, in) (also the
  discriminator's Downsample ``proj``, which runs it as a 2×2 conv)
- Conv ``kernel`` (kh, kw, in, out) → conv ``weight`` (out, in, kh, kw)
- EqualLinear ``weight`` (in, out) (``style_net/linear_i``) → (out, in)
- kernel banks ``weights`` (n, kh, kw, in, out), ``init_block`` (4, 4, c),
  Noise ``weight``, RMSNorm ``gamma``, ``null_kv`` and biases: as they are.

Every leaf must land on a parameter of the target module and every
parameter must be filled, with matching shapes — otherwise it raises.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_STAGE = re.compile(r"^stages_(\d+)_(\w+)$")


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = (*prefix, str(key))
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def _torch_key_and_value(path, arr):
    head, *rest = path
    m = _STAGE.match(head)
    segments = ["stages", m.group(1), m.group(2)] if m else [head]
    segments += rest
    leaf = segments[-1]
    if leaf == "kernel":
        if arr.ndim not in (2, 4):
            raise ValueError(f"{'/'.join(path)}: a kernel must be a 2-D "
                             f"Dense or 4-D Conv kernel, got {arr.shape}")
        segments[-1] = "weight"
        arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
    elif leaf == "weight" and arr.ndim == 2:  # EqualLinear (in, out)
        arr = arr.T
    return ".".join(segments), arr


def convert_params(params, module: torch.nn.Module):
    """→ state_dict for ``module`` (float32 CPU tensors)."""
    state = {}
    for path, arr in _flatten(params):
        key, val = _torch_key_and_value(path, arr)
        if key in state:
            raise ValueError(f"two JAX leaves map to {key}")
        state[key] = torch.from_numpy(np.array(val, np.float32, order="C"))

    target = module.state_dict()
    unconsumed = sorted(set(state) - set(target))
    missing = sorted(set(target) - set(state))
    if unconsumed or missing:
        raise ValueError(
            f"JAX params do not match {type(module).__name__}: "
            f"unconsumed JAX leaves {unconsumed}, unfilled parameters "
            f"{missing}"
        )
    for key, val in state.items():
        if tuple(val.shape) != tuple(target[key].shape):
            raise ValueError(
                f"{key}: JAX shape {tuple(val.shape)} (after layout map) != "
                f"parameter shape {tuple(target[key].shape)}"
            )
    return state
