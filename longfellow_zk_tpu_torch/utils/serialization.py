"""Little-endian serialization helpers and a bounds-checked read buffer.

Twin of the reference's util/serialization.h and
util/readbuffer.h (see reference lib/util/serialization.h,
lib/util/readbuffer.h): host-side byte plumbing for proof and circuit
wire formats.  All multi-byte integers are little-endian, matching the
reference wire formats.
"""

from __future__ import annotations


def u8_to_le(x: int) -> bytes:
    return x.to_bytes(1, "little")


def u16_to_le(x: int) -> bytes:
    return x.to_bytes(2, "little")


def u32_to_le(x: int) -> bytes:
    return x.to_bytes(4, "little")


def u64_to_le(x: int) -> bytes:
    return x.to_bytes(8, "little")


def le_to_int(b: bytes) -> int:
    return int.from_bytes(b, "little")


class ReadBuffer:
    """Bounds-checked sequential reader over immutable bytes.

    Mirrors the semantics of the reference ReadBuffer
    (lib/util/readbuffer.h): every read checks remaining length; callers
    decide how to handle failure (we raise ValueError).
    """

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def remaining(self) -> int:
        return len(self._data) - self._pos

    def have(self, n: int) -> bool:
        return self.remaining() >= n

    def bytes(self, n: int) -> bytes:
        if not self.have(n):
            raise ValueError(f"ReadBuffer underflow: want {n}, have {self.remaining()}")
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        return self.bytes(1)[0]

    def u16(self) -> int:
        return le_to_int(self.bytes(2))

    def u32(self) -> int:
        return le_to_int(self.bytes(4))

    def u64(self) -> int:
        return le_to_int(self.bytes(8))
