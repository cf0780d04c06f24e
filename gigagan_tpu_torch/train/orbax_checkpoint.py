"""Reader of the JAX package's orbax checkpoints (the ``model-N.ckpt``
directories of gigagan_tpu's ``GigaGAN.save`` under
``checkpoint_backend="orbax"``), with no orbax, tensorstore or zstd
library: numpy, torch, the OCDBT reader (``train/ocdbt.py``) and the
hand-written zstd decoder (``utils/zstd.py``).

An orbax PyTree checkpoint holds:

- ``_METADATA``, JSON: ``tree_metadata`` maps each leaf's key path (its
  ``key_metadata``: key and key type, 2 a dict key) to a ``value_type``:
  ``np.ndarray`` or ``jax.Array`` (an array), ``scalar`` (a Python
  number), ``None`` or an empty ``Dict`` (optax's empty states); and
  ``use_ocdbt`` and ``use_zarr3``.
- each array as a zarr v2 array named by its key path joined with ``.``:
  ``<name>/.zarray`` and one key per chunk, ``<name>/<i>.<j>...``, in the
  OCDBT database of the directory (``use_ocdbt``) or as files under
  ``<name>/`` (``use_ocdbt=False``);
- ``VERSION``, written beside them by the JAX trainer.

Arrays come back as CPU tensors (``bfloat16`` read as ``uint16`` viewed as
``torch.bfloat16``, as the msgpack reader does), scalars as Python
numbers, empty dicts and None as themselves: the tree that orbax's
``PyTreeCheckpointer.restore`` gives, with tensors for arrays.  zarr v3
(``use_zarr3``), codecs other than zstd, and lists or tuples (sequence
keys, empty ``List`` or ``Tuple`` values) raise ``NotImplementedError``:
the JAX package writes none of them (a train state is flax's state dict,
dicts all the way down).
"""

from __future__ import annotations

import itertools
import json
import math
from pathlib import Path

import numpy as np
import torch

from gigagan_tpu_torch.train.ocdbt import OcdbtReader
from gigagan_tpu_torch.utils import zstd

DICT_KEY = 2  # orbax's KeyType.DICT (1: a sequence index)


def _dtype(name: str, where: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype("<u2")
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise NotImplementedError(f"{where}: zarr dtype {name!r}") from e
    if dt.kind not in "biuf" or dt.fields is not None:
        raise NotImplementedError(f"{where}: zarr dtype {name!r}")
    return dt


def _fill(value, dt: np.dtype, bf16: bool):
    if value is None:
        return 0
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        value = float(value)
    if bf16:
        bits = torch.tensor(value, dtype=torch.float32).to(torch.bfloat16)
        return int(bits.view(torch.int16)) & 0xFFFF
    return value


def read_zarr(get, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` as a CPU tensor; ``get(key)`` returns a
    key's bytes or None (a missing chunk holds the fill value)."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"{name}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"{name}: zarr format "
                                  f"{meta.get('zarr_format')}")
    if meta.get("filters") or meta.get("order", "C") != "C":
        raise NotImplementedError(f"{name}: zarr filters or order "
                                  f"{meta.get('order')!r}")
    codec = (meta.get("compressor") or {}).get("id")
    if codec not in (None, "zstd"):
        raise NotImplementedError(f"{name}: zarr compressor {codec!r}")
    bf16 = meta["dtype"] == "bfloat16"
    dt = _dtype(meta["dtype"], name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dt)
    chunk_bytes = math.prod(chunks) * dt.itemsize

    def decode(data, dst):
        if codec is None:
            if len(data) != chunk_bytes:
                raise ValueError(f"{name}: a chunk of {len(data)} bytes "
                                 f"(want {chunk_bytes})")
            dst.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)
        elif zstd.decompress_into(data, dst.reshape(-1).view(np.uint8)) \
                != chunk_bytes:
            raise ValueError(f"{name}: a chunk does not decode to "
                             f"{chunk_bytes} bytes")

    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        data = get(f"{name}/{sep.join(map(str, index)) or '0'}")
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        if data is None:
            out[region] = _fill(meta.get("fill_value"), dt, bf16)
        elif chunks == shape:  # the whole array: decode in place
            decode(data, out)
        else:
            buf = np.empty(chunks, dt)
            decode(data, buf)
            out[region] = buf[tuple(slice(0, r.stop - r.start)
                                    for r in region)]
    if not dt.isnative:
        out = out.astype(dt.newbyteorder("="))
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if bf16 else t


def _store(path: Path, meta: dict):
    """``get(key) -> bytes or None`` over the checkpoint's arrays."""
    if meta.get("use_zarr3"):
        raise NotImplementedError(
            f"{path}: use_zarr3=True (zarr v3) is not read; the JAX package "
            "saves zarr v2")
    if meta.get("use_ocdbt", True):
        db = []  # opened at the first read: a tree without arrays has none

        def read(key):
            if not db:
                db.append(OcdbtReader(path))
            return db[0].read(key) if key in db[0] else None

        return read

    def get(key):
        f = path / key
        return f.read_bytes() if f.is_file() else None

    return get


def restore(path) -> dict:
    """The tree of an orbax PyTree checkpoint directory, arrays as CPU
    tensors."""
    path = Path(path)
    meta_path = path / "_METADATA"
    if not meta_path.is_file():
        raise ValueError(f"{path} has no _METADATA: not an orbax PyTree "
                         "checkpoint")
    meta = json.loads(meta_path.read_text())
    get = _store(path, meta)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        kind = entry["value_metadata"]["value_type"]
        if any(k["key_type"] != DICT_KEY for k in entry["key_metadata"]):
            raise NotImplementedError(f"{path}: a list or tuple at {keys}; "
                                      "a GigaGAN state holds dicts only")
        if kind in ("np.ndarray", "jax.Array"):
            value = read_zarr(get, ".".join(keys))
        elif kind == "scalar":
            value = read_zarr(get, ".".join(keys)).item()
        elif kind == "None":
            value = None
        elif kind == "Dict":
            value = {}
        else:
            raise NotImplementedError(f"{path}: orbax value type {kind!r} "
                                      f"at {keys}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def read_orbax(path) -> dict:
    """The payload of an orbax checkpoint of the JAX trainer, as the
    msgpack reader gives it: {"state", "rng", "version"}.  The round-1
    layout, a bare state dict, comes back with ``rng`` None."""
    path = Path(path)
    tree = restore(path)
    version_file = path / "VERSION"
    version = version_file.read_text() if version_file.is_file() else None
    tree.pop("VERSION", None)
    if "state" not in tree:
        return {"state": tree, "rng": None, "version": version}
    return {"state": tree["state"], "rng": tree.get("rng"),
            "version": version}
