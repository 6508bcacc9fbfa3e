"""Fiat-Shamir transcript and FSPRF.

Byte-exact twin of the reference Transcript/FSPRF
(lib/random/transcript.h:33-193) and RandomEngine (lib/random/random.h:32):

  - running SHA-256 absorb with 1-byte type tags (BSTR=0, FIELD_ELEM=1,
    ARRAY=2) and 8-byte little-endian lengths;
  - squeeze: fork+finalize the SHA state into a 32-byte key for an
    AES-256-ECB PRF run in counter mode (16-byte LE block counter);
  - any write invalidates the PRF;
  - rejection sampling for field elements (via Field.sample), naturals
    (`nat`), and the distinct-index `choose` used for Ligero column
    openings.

This is deliberately host-side Python: Fiat-Shamir is a strictly
sequential few-KB byte stream between device phases; the device computes
the large messages, the host folds them into the oracle.  Verified
against docs/specs/testvectors.md vectors.
"""

from __future__ import annotations

from typing import List, Sequence

from ..utils.crypto import (
    PRF,
    PRF_INPUT_SIZE,
    PRF_KEY_SIZE,
    PRF_OUTPUT_SIZE,
    SHA256,
)

TAG_BSTR = 0
TAG_FIELD_ELEM = 1
TAG_ARRAY = 2


class FSPRF:
    """AES-256-ECB in counter mode (transcript.h:33-68)."""

    kMaxBlocks = 0x10000000000

    def __init__(self, key: bytes):
        assert len(key) == PRF_KEY_SIZE
        self._prf = PRF(key)
        self._nblock = 0
        self._saved = b""
        self._rdptr = PRF_OUTPUT_SIZE

    def bytes(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._rdptr == PRF_OUTPUT_SIZE:
                self._refill()
            take = min(n, PRF_OUTPUT_SIZE - self._rdptr)
            out += self._saved[self._rdptr : self._rdptr + take]
            self._rdptr += take
            n -= take
        return bytes(out)

    def _refill(self):
        assert self._nblock < self.kMaxBlocks, "too many blocks"
        block = self._nblock.to_bytes(8, "little") + b"\x00" * (PRF_INPUT_SIZE - 8)
        self._saved = self._prf.eval(block)
        self._nblock += 1
        self._rdptr = 0


class Transcript:
    """Fiat-Shamir oracle (transcript.h:70-193 + random.h:32-116)."""

    def __init__(self, init: bytes, version: int = 6, _sha: SHA256 = None):
        self._sha = SHA256() if _sha is None else _sha
        self._prf = None
        self.version = version
        if _sha is None:
            self.write_bytes(init)

    def clone(self) -> "Transcript":
        return Transcript(b"", self.version, _sha=self._sha.copy())

    # -- state migration (host <-> device transcript) ------------------------

    def export_state(self) -> bytes:
        """SHA-256 midstate blob (utils.crypto.SHA256_STATE_SIZE bytes).
        Only valid between squeezes (the PRF is not exported)."""
        return self._sha.export_state()

    def import_state(self, blob: bytes) -> None:
        self._prf = None
        self._sha.import_state(blob)

    # -- typed writes -------------------------------------------------------

    def _tag(self, t: int):
        self._write_untyped(bytes([t]))

    def _length(self, n: int):
        self._write_untyped(n.to_bytes(8, "little"))

    def _write_untyped(self, data: bytes):
        self._prf = None  # invalidate PRF on any write
        self._sha.update(data)

    def write_bytes(self, data: bytes):
        self._tag(TAG_BSTR)
        self._length(len(data))
        self._write_untyped(data)

    def write0(self, n: int):
        self._tag(TAG_BSTR)
        self._length(n)
        self._prf = None
        self._sha.update0(n)

    def write_elt(self, e, F):
        self._tag(TAG_FIELD_ELEM)
        self._write_untyped(F.to_bytes(e))

    def write_elts(self, es: Sequence, F):
        self._tag(TAG_ARRAY)
        self._length(len(es))
        for e in es:
            self._write_untyped(F.to_bytes(e))

    # -- squeeze ------------------------------------------------------------

    def get_key(self) -> bytes:
        return self._sha.copy().digest()

    def bytes(self, n: int) -> bytes:
        if self._prf is None:
            self._prf = FSPRF(self.get_key())
        return self._prf.bytes(n)

    def elt(self, F):
        return F.sample(self.bytes)

    def elts(self, n: int, F) -> List:
        return [self.elt(F) for _ in range(n)]

    def subfield_elt(self, F):
        return F.sample_subfield(self.bytes)

    def nat(self, n: int) -> int:
        """Random natural < n by rejection (random.h:57-89)."""
        assert n > 0
        l = 0
        nn = n
        while nn:
            nn >>= 8
            l += 1
        msk = self._mask(n)
        while True:
            r = int.from_bytes(self.bytes(l), "little") & msk
            if r < n:
                return r

    @staticmethod
    def _mask(n: int) -> int:
        mask = 0
        while (n & mask) != n:
            mask = (mask << 1) | 1
        return mask

    def choose(self, n: int, k: int) -> List[int]:
        """K distinct naturals in [0, n) (random.h:93-105)."""
        assert n >= k
        A = list(range(n))
        res = []
        for i in range(k):
            j = i + self.nat(n - i)
            A[i], A[j] = A[j], A[i]
            res.append(A[i])
        return res
