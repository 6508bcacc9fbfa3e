"""Random engines (reference lib/random/secure_random_engine.h and
lib/algebra/bogorng.h test RNG)."""

from __future__ import annotations

import hashlib
import os


class SecureRandomEngine:
    """OS randomness (reference SecureRandomEngine wraps RAND_bytes)."""

    def bytes(self, n: int) -> bytes:
        return os.urandom(n)


class DeterministicEngine:
    """Deterministic byte stream for reproducible tests (Bogorng analogue)."""

    def __init__(self, seed: bytes = b"bogorng"):
        self._seed = seed
        self._ctr = 0
        self._buf = b""

    def bytes(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._buf += hashlib.sha256(
                self._seed + self._ctr.to_bytes(8, "little")
            ).digest()
            self._ctr += 1
        out, self._buf = self._buf[:n], self._buf[n:]
        return out
