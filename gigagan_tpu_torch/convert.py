"""Weight bridge: a JAX parameter tree (the generator's, the
discriminator's, the vision-aided discriminator's with its ``buffers``
collection, or any of their layers') → the state_dict of this package's
twin module; and a flax ``CLIPModel`` tree → the port's CLIP, whose
parameters carry open_clip's names (``convert_clip_params``).

Input: the flax ``params`` tree as nested mappings of arrays (for example
``jax.device_get(params)``; anything ``np.asarray`` accepts).  Naming and
layout map as follows:

- ``stages_{s}_{name}/...``   → ``stages.{s}.{name}....`` (and the
  upsampler's ``downs_{s}_{name}``, ``ups_{s}_{name}``)
- Dense ``kernel`` (in, out)  → Linear ``weight`` (out, in) (also the
  discriminator's Downsample ``proj``, which runs it as a 2×2 conv)
- Conv ``kernel`` (kh, kw, in, out) → conv ``weight`` (out, in, kh, kw),
  and a 1-D Conv ``kernel`` (k, in, out) → (out, in, k)
- EqualLinear ``weight`` (in, out) (``style_net/linear_i``) → (out, in)
- kernel banks ``weights`` (n, kh, kw, in, out) or (n, k, in, out),
  ``init_block`` (4, 4, c),
  Noise ``weight``, RMSNorm ``gamma``, ``null_kv``,
  ``learned_global_token``, ``fixed_weights`` buffers (in, out) and
  biases: as they are.

Every leaf must land on a parameter of the target module and every
parameter must be filled, with matching shapes — otherwise it raises.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_STAGE = re.compile(r"^(stages|downs|ups)_(\d+)_(\w+)$")


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
    segments = list(m.groups()) if m else [head]
    segments += rest
    leaf = segments[-1]
    if leaf == "kernel":
        if arr.ndim not in (2, 3, 4):
            raise ValueError(f"{'/'.join(path)}: a kernel must be a 2-D "
                             f"Dense or 3-D/4-D Conv kernel, got {arr.shape}")
        segments[-1] = "weight"
        arr = arr.T if arr.ndim == 2 else np.moveaxis(arr, (-1, -2), (0, 1))
    elif leaf == "weight" and arr.ndim == 2:  # EqualLinear (in, out)
        arr = arr.T
    return ".".join(segments), arr


def _merge(a, b):
    """Two nested mappings as one (a flax module's collections)."""
    out = dict(a)
    for key, val in b.items():
        out[key] = (_merge(out[key], val) if key in out
                    and isinstance(val, Mapping) else val)
    return out


def convert_params(params, module: torch.nn.Module, buffers=None):
    """→ state_dict for ``module`` (float32 CPU tensors); ``buffers``: the
    module's flax ``buffers`` collection, where it has one."""
    if buffers is not None:
        params = _merge(params, buffers)
    return _checked((_torch_key_and_value(path, arr)
                     for path, arr in _flatten(params)), module)


def _checked(pairs, module):
    state = {}
    for key, val in pairs:
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


def _clip_block(tree, prefix):
    """A flax CLIP ``ResidualAttentionBlock`` → open_clip's names; the
    attention's per-head q/k/v kernels (w, h, d) pack into
    ``in_proj_weight`` (3w, w)."""
    attn = tree["attn"]
    width = np.asarray(attn["query"]["kernel"]).shape[0]

    def dense(t):
        return np.asarray(t["kernel"]).reshape(width, -1).T

    yield f"{prefix}.attn.in_proj_weight", np.concatenate(
        [dense(attn[k]) for k in ("query", "key", "value")])
    yield f"{prefix}.attn.in_proj_bias", np.concatenate(
        [np.asarray(attn[k]["bias"]).reshape(-1)
         for k in ("query", "key", "value")])
    yield f"{prefix}.attn.out_proj.weight", np.asarray(
        attn["out"]["kernel"]).reshape(-1, width).T
    yield f"{prefix}.attn.out_proj.bias", attn["out"]["bias"]
    for ln in ("ln_1", "ln_2"):
        yield from _layer_norm(tree[ln], f"{prefix}.{ln}")
    for flax_name, name in (("mlp_fc", "c_fc"), ("mlp_proj", "c_proj")):
        yield f"{prefix}.mlp.{name}.weight", np.asarray(
            tree[flax_name]["kernel"]).T
        yield f"{prefix}.mlp.{name}.bias", tree[flax_name]["bias"]


def _layer_norm(tree, prefix):
    yield f"{prefix}.weight", tree["scale"]
    yield f"{prefix}.bias", tree["bias"]


def _clip_pairs(params):
    visual, text = params["visual"], params["text"]
    # conv kernel (p, p, 3, w) → (w, 3, p, p)
    yield "visual.conv1.weight", np.asarray(
        visual["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    for name in ("class_embedding", "positional_embedding", "proj"):
        yield f"visual.{name}", visual[name]
    for ln in ("ln_pre", "ln_post"):
        yield from _layer_norm(visual[ln], f"visual.{ln}")
    yield "token_embedding.weight", text["token_embedding"]["embedding"]
    for name in ("positional_embedding", "text_projection"):
        yield name, text[name]
    yield from _layer_norm(text["ln_final"], "ln_final")
    for tower, prefix in ((visual, "visual.transformer"),
                          (text, "transformer")):
        for key in tower:
            m = re.match(r"^resblock_(\d+)$", key)
            if m:
                yield from _clip_block(tower[key],
                                       f"{prefix}.resblocks.{m.group(1)}")
    yield "logit_scale", params["logit_scale"]


def convert_clip_params(params, model: torch.nn.Module):
    """A flax ``CLIPModel`` params tree → the state_dict of the port's
    ``CLIPModel`` (open_clip's names and layouts); every leaf consumed and
    every parameter filled, as ``convert_params`` checks."""
    state = _checked(_clip_pairs(params), model)
    leaves = sum(a.size for _, a in _flatten(params))
    if leaves != sum(v.numel() for v in state.values()):
        mapped = sum(v.numel() for v in state.values())
        raise ValueError(f"flax CLIP params hold {leaves} values, the "
                         f"mapped ones {mapped}: a leaf was not consumed")
    return state
