"""A read-only reader of tensorstore's OCDBT key-value store (the
``manifest.ocdbt`` database that orbax writes a checkpoint's arrays into),
with no tensorstore: the standard library and the hand-written zstd
decoder and CRC-32C of ``utils/zstd.py``.

The format, as tensorstore writes it (worked out from its files, with
tensorstore's ``ocdbt`` kvstore as the oracle in
``tests/test_torch_orbax.py``):

- Every manifest, B+-tree node and version-tree node is an encoded record,
  a whole file or a byte range of a data file: magic (u32 big-endian,
  ``0x0cdb3a2a`` for a manifest, ``0x0cdb20de`` for a node), its own
  length (u64 little-endian), a format version (varint, 0), a compression
  (varint: 0 none, 1 zstd), the body (one zstd frame when compressed), and
  the CRC-32C of everything before it (u32 little-endian).
- Varints are LEB128.  Arrays of fields are stored field by field: all
  the entries' first fields, then all their second fields, and so on.
- A manifest's body: a 16-byte uuid, the manifest kind (varint: 0 single;
  1 numbered, whose versions live in the highest-numbered
  ``manifest.<16 hex digits>``), max inline value bytes and max decoded
  node bytes (varints), the version tree's arity log2 (u8), the
  compression (varint; zstd adds its level, i32 little-endian); then a
  data-file table and the latest versions: count, generation numbers,
  root heights (u8), root data-file ids, offsets and lengths, key counts,
  tree bytes and indirect value bytes (varints), commit times (u64).
  References to older version-tree nodes follow and are not read: the
  newest version is the last inline one.  An empty tree's root length is
  2**64 - 1.
- A data-file table: the count; each path's prefix length shared with
  the previous path (count - 1 varints); the suffix lengths; the base-path
  lengths; the suffixes.  Paths are relative to the database root; a
  node read from a data file whose base path is ``B`` resolves its own
  table under ``B`` (how a multi-process save's top-level tree points
  into ``ocdbt.process_N/``).
- A B+-tree node's body: height (u8), a data-file table, the entry count,
  the keys' prefix lengths shared with the previous key (count - 1) and
  suffix lengths, for an interior node each entry's subtree common prefix
  length, then the key suffixes.  A leaf follows with the value lengths,
  the value kinds (0 inline, 1 in a data file), the data-file ids and
  offsets of the indirect values, and the inline values in order.  An
  interior node follows with its children's data-file ids, offsets,
  lengths, key counts, tree bytes and indirect value bytes.  A child's
  keys are relative to its parent's key prefix plus the first subtree
  common prefix length bytes of its entry's key.
"""

from __future__ import annotations

import re
from pathlib import Path

from gigagan_tpu_torch.utils import zstd

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
MISSING = 2 ** 64 - 1
_NUMBERED = re.compile(r"manifest\.[0-9a-f]{16}")


class _Cursor:
    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.where}: truncated OCDBT record")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.where}: varint too long")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def _read_range(path: Path, offset: int, length: int) -> bytes:
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read(length)
    if len(data) != length:
        raise ValueError(f"{path}: {length} bytes at {offset} run past the "
                         "end of the file")
    return data


def _body(raw: bytes, magic: int, where: str) -> bytes:
    """An encoded record's body, its header, length and CRC-32C checked."""
    if len(raw) < 18 or int.from_bytes(raw[:4], "big") != magic:
        kind = "manifest" if magic == MANIFEST_MAGIC else "node"
        raise ValueError(f"{where}: not an OCDBT {kind}")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise ValueError(f"{where}: record length does not match")
    if zstd.crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"{where}: CRC-32C mismatch")
    c = _Cursor(raw[:-4], where)
    c.pos = 12
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise NotImplementedError(f"{where}: OCDBT format version {version}")
    body = raw[c.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise NotImplementedError(f"{where}: OCDBT compression {compression}")


def _file_table(c: _Cursor, base: str) -> list:
    """[(path, base path)] relative to the database root."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix, base_len = c.varints(n), c.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{c.where}: bad data-file table")
        path = prev[:prefix[i]] + c.take(suffix[i])
        if base_len[i] > len(path):
            raise ValueError(f"{c.where}: bad data-file table")
        out.append((base + path.decode(), base + path[:base_len[i]].decode()))
        prev = path
    return out


def _keys(c: _Cursor, n: int, interior: bool):
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{c.where}: bad key prefix")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        keys.append(prev)
    return keys, common


class OcdbtReader:
    """The newest version of the OCDBT database under ``root``: ``keys()``
    and ``read(key) -> bytes``.  Every node is read and checked when the
    reader opens; values in data files are read on ``read``."""

    def __init__(self, root):
        self.root = Path(root)
        self._values: dict = {}  # key -> bytes, or (path, offset, length)
        table, fid, offset, length, height = self._latest_root()
        if length != MISSING:
            self._walk(table, fid, offset, length, b"", height)

    def keys(self) -> list:
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def read(self, key: str) -> bytes:
        value = self._values[key]
        return value if isinstance(value, bytes) else _read_range(*value)

    def _latest_root(self):
        path = self.root / "manifest.ocdbt"
        c, kind = self._manifest(path)
        if kind == 1:
            numbered = sorted(p.name for p in self.root.iterdir()
                              if _NUMBERED.fullmatch(p.name))
            if not numbered:
                raise ValueError(f"{path}: numbered manifest without a "
                                 "manifest.<number> file")
            path = self.root / numbered[-1]
            c, _ = self._manifest(path)
        elif kind != 0:
            raise NotImplementedError(f"{path}: manifest kind {kind}")
        table = _file_table(c, "")
        n = c.varint()
        if n == 0:
            raise ValueError(f"{path}: no version")
        c.varints(n)  # generation numbers, ascending
        heights = [c.u8() for _ in range(n)]
        fids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
        if lengths[-1] != MISSING and fids[-1] >= len(table):
            raise ValueError(f"{path}: bad data-file id")
        return table, fids[-1], offsets[-1], lengths[-1], heights[-1]

    @staticmethod
    def _manifest(path: Path):
        """(a cursor past the manifest's config, its manifest kind)."""
        c = _Cursor(_body(path.read_bytes(), MANIFEST_MAGIC, str(path)),
                    str(path))
        c.take(16)  # uuid
        kind = c.varint()
        c.varint(), c.varint(), c.u8()  # inline and node limits, arity
        if c.varint() == 1:
            c.take(4)  # zstd level
        return c, kind

    def _walk(self, table, fid, offset, length, prefix, height):
        path, base = table[fid]
        where = f"{self.root / path}@{offset}"
        c = _Cursor(_body(_read_range(self.root / path, offset, length),
                          NODE_MAGIC, where), where)
        if c.u8() != height:
            raise ValueError(f"{where}: node height does not match")
        table = _file_table(c, base)
        n = c.varint()
        keys, common = _keys(c, n, height > 0)
        if height == 0:
            lengths, kinds = c.varints(n), c.varints(n)
            indirect = sum(kinds)
            fids, offsets = c.varints(indirect), c.varints(indirect)
            j = 0
            for key, size, kind in zip(keys, lengths, kinds):
                if kind == 0:
                    value = c.take(size)
                elif kind == 1 and fids[j] < len(table):
                    value = (self.root / table[fids[j]][0], offsets[j], size)
                    j += 1
                else:
                    raise ValueError(f"{where}: bad value reference")
                self._values[(prefix + key).decode()] = value
        else:
            fids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)  # key counts, tree bytes, indirect bytes
            for key, cp, f, o, ln in zip(keys, common, fids, offsets,
                                         lengths):
                if f >= len(table) or cp > len(key):
                    raise ValueError(f"{where}: bad child reference")
                self._walk(table, f, o, ln, prefix + key[:cp], height - 1)
        if c.pos != len(c.data):
            raise ValueError(f"{where}: {len(c.data) - c.pos} bytes after "
                             "the node's entries")
