"""Native runtime loader.

Builds lfzk_native.c once (cc -O2 -shared) into the package's ignored
build directory (`longfellow_zk_tpu_torch/_build/`) and exposes it via
ctypes.  The native library carries the host-side crypto (streaming
SHA-256 with exportable midstate, AES-256 block encrypt) of the
Fiat-Shamir transcript and the Merkle column hashes — the analogue of the
reference's OpenSSL dependency (lib/util/crypto.h).

If no C compiler is available the callers fall back to pure-Python
implementations (utils/crypto.py), which are bit-identical but slower.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_lock = threading.Lock()
_lib = None
_tried = False

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_dir() -> str:
    d = os.path.join(PKG_DIR, "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _compile() -> str:
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "lfzk_native.c")
    out = os.path.join(build_dir(), "liblfzk_native.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    tmp = "%s.%d.tmp" % (out, os.getpid())
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-o", tmp, src],
                check=True, capture_output=True)
            os.replace(tmp, out)
            return out
        except (OSError, subprocess.CalledProcessError):
            continue
    raise RuntimeError("no C compiler available")


def get_lib():
    """Returns the loaded ctypes library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = _compile()
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError):
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.lfzk_sha256_ctx_size.restype = ctypes.c_int
        lib.lfzk_aes256_ctx_size.restype = ctypes.c_int
        lib.lfzk_sha256_init.argtypes = [ctypes.c_void_p]
        lib.lfzk_sha256_update.argtypes = [ctypes.c_void_p, u8p,
                                           ctypes.c_uint64]
        lib.lfzk_sha256_update0.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.lfzk_sha256_final.argtypes = [ctypes.c_void_p, u8p]
        lib.lfzk_sha256_export.argtypes = [ctypes.c_void_p, u8p]
        lib.lfzk_sha256_import.argtypes = [ctypes.c_void_p, u8p]
        lib.lfzk_aes256_init.argtypes = [ctypes.c_void_p, u8p]
        lib.lfzk_aes256_encrypt.argtypes = [ctypes.c_void_p, u8p, u8p]
        _lib = lib
        return _lib


def buf(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
