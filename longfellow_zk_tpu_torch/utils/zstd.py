"""Zstandard decompression through the system libzstd (ctypes), for the
zstd-compressed LFC1 circuit files (reference
lib/circuits/mdoc/decompress.cc:28-40).  Copied from the JAX package's
utils/zstd.py, decompression only.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_lib = None

# Largest decompressed circuit (mdoc_zk.h kCircuitSizeMax analogue).
K_CIRCUIT_SIZE_MAX = 1 << 30


def _get():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        lib = ctypes.CDLL(name)
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p,
                                                 ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_char_p, ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        _lib = lib
    return _lib


def decompress(data: bytes, max_size: int = K_CIRCUIT_SIZE_MAX) -> bytes:
    """Decompresses one zstd frame (reference decompress.cc:28-40)."""
    lib = _get()
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size in (2**64 - 1, 2**64 - 2) or size > max_size:  # error/unknown
        size = max_size
    out = ctypes.create_string_buffer(int(size))
    n = lib.ZSTD_decompress(out, int(size), data, len(data))
    if lib.ZSTD_isError(n):
        raise ValueError("zstd decompression failed")
    return out.raw[:n]
