"""zstd frames and CRC-32C through the hand-written host decoder
``csrc/zstd_decode.c`` (RFC 8878, no dictionaries), built with the host C
compiler at first use and loaded with ctypes (``ops/kernels/build.py``).
No zstd library is loaded: the orbax reader (``train/orbax_checkpoint.py``)
needs nothing but this file, numpy and torch.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from gigagan_tpu_torch.ops.kernels import build

UNKNOWN_SIZE, DST_TOO_SMALL = -8, -4
_LIB: list = []
_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    with _LOCK:
        if not _LIB:
            lib = build.load("zstd_decode")
            lib.zstd_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
            lib.zstd_decode.restype = ctypes.c_int64
            lib.zstd_decoded_size.argtypes = [ctypes.c_char_p,
                                              ctypes.c_size_t]
            lib.zstd_decoded_size.restype = ctypes.c_int64
            lib.zstd_error_name.argtypes = [ctypes.c_int64]
            lib.zstd_error_name.restype = ctypes.c_char_p
            lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.crc32c.restype = ctypes.c_uint32
            _LIB.append(lib)
        return _LIB[0]


class ZstdError(ValueError):
    def __init__(self, code: int):
        super().__init__(f"zstd: {_lib().zstd_error_name(code).decode()}")
        self.code = code


def decompress_into(data: bytes, out: np.ndarray) -> int:
    """Decode every frame of ``data`` into the C-contiguous array ``out``
    (its bytes); returns the bytes written."""
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("decompress_into needs a writeable C-contiguous "
                         "array")
    data = bytes(data)
    n = _lib().zstd_decode(data, len(data), out.ctypes.data, out.nbytes)
    if n < 0:
        raise ZstdError(n)
    return n


def decompress(data: bytes) -> bytes:
    """The bytes that the zstd frames in ``data`` encode: into the frames'
    declared content size or, where a frame declares none (tensorstore's
    do not), a capacity doubled until it fits."""
    data = bytes(data)
    size = _lib().zstd_decoded_size(data, len(data))
    if size == UNKNOWN_SIZE:
        cap = max(4 * len(data), 1 << 16)
        while True:
            out = np.empty(cap, np.uint8)
            try:
                return out[:decompress_into(data, out)].tobytes()
            except ZstdError as e:
                if e.code != DST_TOO_SMALL:
                    raise
            cap *= 2
    if size < 0:
        raise ZstdError(size)
    out = np.empty(size, np.uint8)
    return out[:decompress_into(data, out)].tobytes()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT's nodes and manifests carry it."""
    data = bytes(data)
    return int(_lib().crc32c(data, len(data)))
