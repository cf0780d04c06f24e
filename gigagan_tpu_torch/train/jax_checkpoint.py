"""Reader of the JAX package's checkpoints (``model-N.ckpt`` of
gigagan_tpu's ``GigaGAN.save``), with no ``flax``, ``msgpack`` or
``ml_dtypes``: the standard library, numpy and torch only.  An orbax
checkpoint directory (``checkpoint_backend="orbax"``) is read by
``train/orbax_checkpoint.py`` into the same payload.

A checkpoint is ``flax.serialization.msgpack_serialize`` of ``{"state",
"rng", "version"}``; ``state`` is flax's state dict of ``GANState``:
``g_params``, ``d_params``, ``g_opt``, ``d_opt``, ``ema`` (``{params,
initted, step}`` or nil), ``steps``, ``vd_params``, ``vd_buffers`` and
``vd_opt``.

``msgpack_restore`` decodes the msgpack maps, arrays, strings, bins,
ints, floats, bools and nil, flax's ext types 1 (an ndarray: a packed
``(shape, dtype name, bytes)``; ``bfloat16`` comes by name and is read as
raw ``uint16`` viewed as ``torch.bfloat16``) and 3 (a numpy scalar), and
flax's chunked arrays (``__msgpack_chunked_array__``, written for leaves
past 2**30 bytes).  Every array and numpy scalar comes back as a CPU
tensor.  Ext type 2 (a complex number) raises: no GigaGAN state holds one.

``port_state`` maps the JAX state onto a trainer in the layout of the
port's own ``torch.save`` checkpoint, so that ``GigaGAN.load`` applies
either one with the same tolerant (or strict) rules:

- the parameter trees go through the weight bridge's names and layouts
  (``convert.py``); the EMA's params fill ``G_ema`` (``g_params`` when the
  checkpoint has no EMA), its ``step`` and ``initted`` the port's EMA;
- the optimizer states: optax Adam(W)'s per-leaf ``count``/``mu``/``nu``
  become torch's ``step``/``exp_avg``/``exp_avg_sq`` per parameter through
  the same names; the flat layout ``{count, m, v[, wd_mask]}``
  (``flat_adamw``) is cut into leaves in the parameter tree's flatten
  order (keys sorted, as JAX flattens a dict); a state that fits neither
  comes back as None, and ``load`` resets that optimizer;
- ``rng`` is a JAX PRNG key.  It cannot seed torch's generators and is
  not emulated: the trainer keeps its own host RNG and says so.
"""

from __future__ import annotations

import struct
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from gigagan_tpu_torch.convert import _flatten, _merge, _torch_key_and_value
from gigagan_tpu_torch.train import orbax_checkpoint

CHUNKED = "__msgpack_chunked_array__"
ZIP_MAGIC = b"PK\x03\x04"

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------------ reader


class _Reader:
    """A msgpack decoder over one buffer (the subset flax writes, plus
    every scalar type of the format)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # strings as bytes, as flax reads an ndarray's

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.unpack(sizes[b - 0xC4])))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            n = self.unpack(sizes[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return self.str(self.unpack(sizes[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} is not msgpack")

    def str(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload).reshape(())
        if code == _EXT_COMPLEX:
            raise ValueError("a complex number in a checkpoint: no GigaGAN "
                             "state holds one")
        raise ValueError(f"unknown msgpack ext type {code}")


def _ndarray(payload: bytes) -> torch.Tensor:
    """flax's ndarray payload: msgpack of (shape, dtype name, C-order
    bytes) → a CPU tensor."""
    shape, name, buffer = _Reader(payload, raw=True).value()
    name = name.decode()
    if name == "bfloat16":
        arr = np.frombuffer(buffer, np.uint16).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    arr = np.frombuffer(buffer, np.dtype(name)).copy()
    return torch.from_numpy(arr).reshape(shape)


def _unchunk(tree):
    """flax's chunked array leaves joined back into tensors."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED) is True:
        shape = [int(tree["shape"][str(i)])
                 for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)]
                  for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The tree that ``flax.serialization.msgpack_serialize`` encoded:
    nested dicts and lists of Python values, arrays and numpy scalars as
    CPU tensors."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack value")
    return _unchunk(tree)


def checkpoint_format(path) -> str:
    """'torch' (a ``torch.save`` zip), 'jax' (a flax msgpack file, which
    starts with a map) or 'orbax' (a directory), by the leading bytes."""
    path = Path(path)
    if path.is_dir():
        return "orbax"
    with open(path, "rb") as f:
        head = f.read(4)
    if head == ZIP_MAGIC:
        return "torch"
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "jax"
    raise ValueError(f"{path} is neither a torch.save zip nor a flax msgpack "
                     f"checkpoint (leading bytes {head!r})")


def read_checkpoint(path) -> dict:
    """The payload of a JAX checkpoint, a flax msgpack file or an orbax
    directory (``train/orbax_checkpoint.py``): {"state", "rng",
    "version"}."""
    path = Path(path)
    if checkpoint_format(path) == "orbax":
        return orbax_checkpoint.read_orbax(path)
    payload = msgpack_restore(path.read_bytes())
    if not isinstance(payload, dict) or "state" not in payload:
        raise ValueError(f"{path} holds no JAX train state")
    return payload


# ----------------------------------------------------------------- mapping


def _to_numpy(t):
    if torch.is_tensor(t):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _named(tree) -> dict:
    """A JAX parameter tree → {torch name: float32 tensor} through the
    weight bridge's names and layouts (nothing checked against a module:
    ``load`` matches by name and shape)."""
    out = {}
    for path, arr in _flatten(_numpy_tree(tree)):
        key, val = _torch_key_and_value(path, arr)
        out[key] = torch.from_numpy(np.array(val, np.float32, order="C"))
    return out


def _numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return _to_numpy(tree)


def _leaves_sorted(tree, prefix=()):
    """(path, leaf) in JAX's flatten order: dict keys sorted."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            yield from _leaves_sorted(val, (*prefix, key))
        else:
            yield (*prefix, key), val


def _set(tree, path, val):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val


def _find_adam(tree):
    """The {count, mu, nu} map inside a serialized optax chain."""
    if not isinstance(tree, Mapping):
        return None
    if {"count", "mu", "nu"} <= set(tree):
        return tree
    for val in tree.values():
        found = _find_adam(val)
        if found is not None:
            return found
    return None


def adam_moments(opt_state, params):
    """(count, mu tree, nu tree) of a JAX optimizer state, optax or flat,
    the trees shaped as ``params``; None if it is neither."""
    adam = _find_adam(opt_state)
    if adam is not None:
        return int(_to_numpy(adam["count"])), adam["mu"], adam["nu"]
    if not (isinstance(opt_state, Mapping)
            and {"count", "m", "v"} <= set(opt_state)):
        return None
    flat_m = _to_numpy(opt_state["m"]).reshape(-1)
    flat_v = _to_numpy(opt_state["v"]).reshape(-1)
    leaves = list(_leaves_sorted(params))
    sizes = [int(np.prod(np.shape(_to_numpy(leaf)))) for _, leaf in leaves]
    if sum(sizes) != flat_m.size or flat_m.size != flat_v.size:
        return None
    mu, nu, start = {}, {}, 0
    for (path, leaf), size in zip(leaves, sizes):
        shape = np.shape(_to_numpy(leaf))
        _set(mu, path, flat_m[start:start + size].reshape(shape))
        _set(nu, path, flat_v[start:start + size].reshape(shape))
        start += size
    return int(_to_numpy(opt_state["count"])), mu, nu


def optimizer_state(opt, module, opt_state, params):
    """A torch ``state_dict`` for ``opt`` (over ``module``'s parameters)
    from a JAX optimizer state, or None when it does not fit: every
    parameter of ``opt`` must find its moments, of its shape, and every
    moment leaf a parameter."""
    if opt_state is None or params is None:
        return None
    try:
        moments = adam_moments(opt_state, params)
        if moments is None:
            return None
        count, mu, nu = moments
        mu, nu = _named(mu), _named(nu)
    except (ValueError, KeyError, TypeError):
        return None
    names = {id(p): n for n, p in module.named_parameters()}
    sd = opt.state_dict()
    order = [p for group in opt.param_groups for p in group["params"]]
    used = set()
    state = {}
    for i, p in enumerate(order):
        name = names.get(id(p))
        if name not in mu or tuple(mu[name].shape) != tuple(p.shape):
            return None
        used.add(name)
        state[i] = {"step": torch.tensor(float(count)),
                    "exp_avg": mu[name].clone(),
                    "exp_avg_sq": nu[name].clone()}
    if set(mu) - used:
        return None
    sd["state"] = state
    return sd


def port_state(payload, gan) -> dict:
    """A JAX checkpoint payload in the layout of the port's ``torch.save``
    checkpoint for ``gan`` (see ``GigaGAN._state``); an optimizer state
    that does not fit is None."""
    jstate = payload["state"]
    saved = {"steps": int(_to_numpy(jstate["steps"])),
             "version": payload.get("version")}
    g_params = jstate.get("g_params")
    ema = jstate.get("ema")
    if g_params is not None:
        saved["G"] = _named(g_params)
        saved["G_ema"] = (_named(ema["params"]) if ema is not None
                          else saved["G"])
    if ema is not None:
        saved["ema"] = {"step": int(_to_numpy(ema["step"])),
                        "initted": bool(_to_numpy(ema["initted"]))}
    if jstate.get("d_params") is not None:
        saved["D"] = _named(jstate["d_params"])
    if jstate.get("vd_params") is not None:
        saved["VD"] = _named(_merge(jstate["vd_params"],
                                    jstate.get("vd_buffers") or {}))
    for key, module, params_key in (("g_opt", "G", "g_params"),
                                    ("d_opt", "D", "d_params"),
                                    ("vd_opt", "VD", "vd_params")):
        opt = getattr(gan, key, None)
        if opt is not None and jstate.get(params_key) is not None:
            saved[key] = optimizer_state(opt, getattr(gan, module),
                                         jstate.get(key),
                                         jstate[params_key])
    return saved
