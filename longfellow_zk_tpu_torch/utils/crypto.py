"""Host-side cryptographic primitives: SHA-256 and an AES-256-ECB PRF.

Semantic twin of the reference lib/util/crypto.h — which wraps OpenSSL's
SHA-256 and AES-256-ECB — rebuilt for a Python host without an OpenSSL
dependency: SHA-256 comes from hashlib (copyable incremental state, as
required by the Fiat-Shamir transcript's fork-and-finalize pattern), and
AES-256 is a small table-based implementation.  These run on the *host*
control plane only, as do the Merkle column hashes of this package's
Ligero commit.

Constants mirror reference lib/util/crypto.h:36-39.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct

from ..native import get_lib, buf as _cbuf

SHA256_DIGEST_SIZE = 32
PRF_KEY_SIZE = 32
PRF_INPUT_SIZE = 16
PRF_OUTPUT_SIZE = 16

# SHA-256 midstate blob: 8*u32 H (LE words) | u64 count | 64-byte buffer
SHA256_STATE_SIZE = 104

_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

_K256 = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2)


def _rotr32(x, n):
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


def _compress_py(h, block):
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr32(w[i - 15], 7) ^ _rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr32(w[i - 2], 17) ^ _rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & 0xFFFFFFFF)
    a, b, c, d, e, f, g, hh = h
    for i in range(64):
        S1 = _rotr32(e, 6) ^ _rotr32(e, 11) ^ _rotr32(e, 25)
        ch = (e & f) ^ (~e & g & 0xFFFFFFFF)
        t1 = (hh + S1 + ch + _K256[i] + w[i]) & 0xFFFFFFFF
        S0 = _rotr32(a, 2) ^ _rotr32(a, 13) ^ _rotr32(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & 0xFFFFFFFF
        hh, g, f = g, f, e
        e = (d + t1) & 0xFFFFFFFF
        d, c, b = c, b, a
        a = (t1 + t2) & 0xFFFFFFFF
    return tuple((x + y) & 0xFFFFFFFF for x, y in
                 zip(h, (a, b, c, d, e, f, g, hh)))


class _PySHA256:
    """Pure-Python streaming SHA-256 with exportable midstate (fallback
    when no C compiler is available)."""

    def __init__(self):
        self.h = _H0
        self.count = 0
        self.buf = b""

    def update(self, data: bytes) -> None:
        self.count += len(data)
        data = self.buf + data
        off = 0
        h = self.h
        while off + 64 <= len(data):
            h = _compress_py(h, data[off : off + 64])
            off += 64
        self.h = h
        self.buf = data[off:]

    def digest(self) -> bytes:
        c = self.copy()
        bits = c.count * 8
        c.update(b"\x80" + b"\x00" * ((55 - c.count) % 64) +
                 bits.to_bytes(8, "big"))
        return b"".join(x.to_bytes(4, "big") for x in c.h)

    def copy(self) -> "_PySHA256":
        c = _PySHA256.__new__(_PySHA256)
        c.h, c.count, c.buf = self.h, self.count, self.buf
        return c

    def export_state(self) -> bytes:
        return (struct.pack("<8I", *self.h) +
                struct.pack("<Q", self.count) +
                self.buf + b"\x00" * (64 - len(self.buf)))

    def import_state(self, blob: bytes) -> None:
        assert len(blob) == SHA256_STATE_SIZE
        self.h = struct.unpack("<8I", blob[:32])
        self.count = struct.unpack("<Q", blob[32:40])[0]
        self.buf = blob[40 : 40 + (self.count % 64)]


class _CSHA256:
    """Native streaming SHA-256 (ctypes over lfzk_native.c)."""

    __slots__ = ("_ctx",)

    def __init__(self, lib=None):
        lib = lib or get_lib()
        self._ctx = ctypes.create_string_buffer(lib.lfzk_sha256_ctx_size())
        lib.lfzk_sha256_init(self._ctx)

    def update(self, data: bytes) -> None:
        get_lib().lfzk_sha256_update(self._ctx, _cbuf(data), len(data))

    def update0(self, n: int) -> None:
        get_lib().lfzk_sha256_update0(self._ctx, n)

    def digest(self) -> bytes:
        out = (ctypes.c_uint8 * 32)()
        get_lib().lfzk_sha256_final(self._ctx, out)
        return bytes(out)

    def copy(self) -> "_CSHA256":
        c = _CSHA256.__new__(_CSHA256)
        c._ctx = ctypes.create_string_buffer(self._ctx.raw, len(self._ctx))
        return c

    def export_state(self) -> bytes:
        out = (ctypes.c_uint8 * SHA256_STATE_SIZE)()
        get_lib().lfzk_sha256_export(self._ctx, out)
        return bytes(out)

    def import_state(self, blob: bytes) -> None:
        assert len(blob) == SHA256_STATE_SIZE
        get_lib().lfzk_sha256_import(self._ctx, _cbuf(blob))


class SHA256:
    """Incremental SHA-256 with copyable + exportable state (reference
    util/crypto.h:41).  The exportable midstate (H, count, buffer) is what
    lets the Fiat-Shamir transcript migrate between the host control plane
    and the on-device transcript mid-stream."""

    def __init__(self):
        self._impl = _CSHA256() if get_lib() is not None else _PySHA256()

    def update(self, data: bytes) -> None:
        self._impl.update(data)

    def update0(self, n: int) -> None:
        """Absorb n zero bytes."""
        if isinstance(self._impl, _CSHA256):
            self._impl.update0(n)
        else:
            self._impl.update(b"\x00" * n)

    def digest(self) -> bytes:
        return self._impl.digest()

    def copy(self) -> "SHA256":
        c = SHA256.__new__(SHA256)
        c._impl = self._impl.copy()
        return c

    def export_state(self) -> bytes:
        return self._impl.export_state()

    def import_state(self, blob: bytes) -> None:
        self._impl.import_state(blob)


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


# ---------------------------------------------------------------------------
# AES-256 (encryption only, single block) — used solely as the Fiat-Shamir
# PRF in counter mode (reference FSPRF, lib/random/transcript.h:33-68).
# Throughput is irrelevant: the transcript squeezes a few KB per proof.
# ---------------------------------------------------------------------------

_SBOX = [
    0x63, 0x7C, 0x77, 0x7B, 0xF2, 0x6B, 0x6F, 0xC5, 0x30, 0x01, 0x67, 0x2B,
    0xFE, 0xD7, 0xAB, 0x76, 0xCA, 0x82, 0xC9, 0x7D, 0xFA, 0x59, 0x47, 0xF0,
    0xAD, 0xD4, 0xA2, 0xAF, 0x9C, 0xA4, 0x72, 0xC0, 0xB7, 0xFD, 0x93, 0x26,
    0x36, 0x3F, 0xF7, 0xCC, 0x34, 0xA5, 0xE5, 0xF1, 0x71, 0xD8, 0x31, 0x15,
    0x04, 0xC7, 0x23, 0xC3, 0x18, 0x96, 0x05, 0x9A, 0x07, 0x12, 0x80, 0xE2,
    0xEB, 0x27, 0xB2, 0x75, 0x09, 0x83, 0x2C, 0x1A, 0x1B, 0x6E, 0x5A, 0xA0,
    0x52, 0x3B, 0xD6, 0xB3, 0x29, 0xE3, 0x2F, 0x84, 0x53, 0xD1, 0x00, 0xED,
    0x20, 0xFC, 0xB1, 0x5B, 0x6A, 0xCB, 0xBE, 0x39, 0x4A, 0x4C, 0x58, 0xCF,
    0xD0, 0xEF, 0xAA, 0xFB, 0x43, 0x4D, 0x33, 0x85, 0x45, 0xF9, 0x02, 0x7F,
    0x50, 0x3C, 0x9F, 0xA8, 0x51, 0xA3, 0x40, 0x8F, 0x92, 0x9D, 0x38, 0xF5,
    0xBC, 0xB6, 0xDA, 0x21, 0x10, 0xFF, 0xF3, 0xD2, 0xCD, 0x0C, 0x13, 0xEC,
    0x5F, 0x97, 0x44, 0x17, 0xC4, 0xA7, 0x7E, 0x3D, 0x64, 0x5D, 0x19, 0x73,
    0x60, 0x81, 0x4F, 0xDC, 0x22, 0x2A, 0x90, 0x88, 0x46, 0xEE, 0xB8, 0x14,
    0xDE, 0x5E, 0x0B, 0xDB, 0xE0, 0x32, 0x3A, 0x0A, 0x49, 0x06, 0x24, 0x5C,
    0xC2, 0xD3, 0xAC, 0x62, 0x91, 0x95, 0xE4, 0x79, 0xE7, 0xC8, 0x37, 0x6D,
    0x8D, 0xD5, 0x4E, 0xA9, 0x6C, 0x56, 0xF4, 0xEA, 0x65, 0x7A, 0xAE, 0x08,
    0xBA, 0x78, 0x25, 0x2E, 0x1C, 0xA6, 0xB4, 0xC6, 0xE8, 0xDD, 0x74, 0x1F,
    0x4B, 0xBD, 0x8B, 0x8A, 0x70, 0x3E, 0xB5, 0x66, 0x48, 0x03, 0xF6, 0x0E,
    0x61, 0x35, 0x57, 0xB9, 0x86, 0xC1, 0x1D, 0x9E, 0xE1, 0xF8, 0x98, 0x11,
    0x69, 0xD9, 0x8E, 0x94, 0x9B, 0x1E, 0x87, 0xE9, 0xCE, 0x55, 0x28, 0xDF,
    0x8C, 0xA1, 0x89, 0x0D, 0xBF, 0xE6, 0x42, 0x68, 0x41, 0x99, 0x2D, 0x0F,
    0xB0, 0x54, 0xBB, 0x16,
]

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36, 0x6C, 0xD8]


def _xtime(a: int) -> int:
    a <<= 1
    if a & 0x100:
        a ^= 0x11B
    return a & 0xFF


_XTIME = [_xtime(i) for i in range(256)]


class AES256:
    """AES-256 block cipher, encryption only (ECB single block)."""

    NR = 14  # rounds for 256-bit keys

    def __init__(self, key: bytes):
        assert len(key) == 32
        self._rk = self._expand_key(key)

    @staticmethod
    def _expand_key(key: bytes):
        nk = 8
        words = [list(key[4 * i : 4 * i + 4]) for i in range(nk)]
        for i in range(nk, 4 * (AES256.NR + 1)):
            t = list(words[i - 1])
            if i % nk == 0:
                t = t[1:] + t[:1]
                t = [_SBOX[b] for b in t]
                t[0] ^= _RCON[i // nk - 1]
            elif i % nk == 4:
                t = [_SBOX[b] for b in t]
            words.append([words[i - nk][j] ^ t[j] for j in range(4)])
        # group into round keys of 16 bytes
        return [sum(words[4 * r : 4 * r + 4], []) for r in range(AES256.NR + 1)]

    def encrypt_block(self, block: bytes) -> bytes:
        assert len(block) == 16
        s = [block[c * 4 + r] for r in range(4) for c in range(4)]  # row-major state
        # state s[r*4+c]
        rk = self._rk

        def add_round_key(s, k):
            # round key is column-major bytes k[4c+r]
            return [s[r * 4 + c] ^ k[4 * c + r] for r in range(4) for c in range(4)]

        def sub_bytes(s):
            return [_SBOX[b] for b in s]

        def shift_rows(s):
            out = list(s)
            for r in range(1, 4):
                row = s[r * 4 : r * 4 + 4]
                out[r * 4 : r * 4 + 4] = row[r:] + row[:r]
            return out

        def mix_columns(s):
            out = [0] * 16
            for c in range(4):
                a = [s[r * 4 + c] for r in range(4)]
                out[0 * 4 + c] = _XTIME[a[0]] ^ (_XTIME[a[1]] ^ a[1]) ^ a[2] ^ a[3]
                out[1 * 4 + c] = a[0] ^ _XTIME[a[1]] ^ (_XTIME[a[2]] ^ a[2]) ^ a[3]
                out[2 * 4 + c] = a[0] ^ a[1] ^ _XTIME[a[2]] ^ (_XTIME[a[3]] ^ a[3])
                out[3 * 4 + c] = (_XTIME[a[0]] ^ a[0]) ^ a[1] ^ a[2] ^ _XTIME[a[3]]
            return out

        s = add_round_key(s, rk[0])
        for rnd in range(1, self.NR):
            s = sub_bytes(s)
            s = shift_rows(s)
            s = mix_columns(s)
            s = add_round_key(s, rk[rnd])
        s = sub_bytes(s)
        s = shift_rows(s)
        s = add_round_key(s, rk[self.NR])
        # state s[r*4+c] back to column-major byte order
        return bytes(s[r * 4 + c] for c in range(4) for r in range(4))


class _CAES256:
    """Native AES-256 block encrypt (ctypes over lfzk_native.c)."""

    __slots__ = ("_ctx",)

    def __init__(self, key: bytes):
        lib = get_lib()
        self._ctx = ctypes.create_string_buffer(lib.lfzk_aes256_ctx_size())
        lib.lfzk_aes256_init(self._ctx, _cbuf(key))

    def encrypt_block(self, block: bytes) -> bytes:
        out = (ctypes.c_uint8 * 16)()
        get_lib().lfzk_aes256_encrypt(self._ctx, _cbuf(block), out)
        return bytes(out)


class PRF:
    """AES-256-ECB pseudo-random function (reference util/crypto.h:74)."""

    def __init__(self, key: bytes):
        assert len(key) == PRF_KEY_SIZE
        self._aes = _CAES256(key) if get_lib() is not None else AES256(key)

    def eval(self, block_in: bytes) -> bytes:
        assert len(block_in) == PRF_INPUT_SIZE
        return self._aes.encrypt_block(block_in)


def rand_bytes(n: int) -> bytes:
    """System randomness (reference util/crypto.h:107 wraps RAND_bytes)."""
    return os.urandom(n)


def hex_to_str(data: bytes) -> str:
    return data.hex()
