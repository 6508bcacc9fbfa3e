"""Host-side CBOR decoder with byte-offset tracking.

Semantic twin of reference lib/cbor/host_decoder.h:30-272: a minimal,
adversarial-input-safe decoder for the CBOR subset used by mDOC, which
records the byte position of every item (the witness generator needs
offsets into the raw document to wire attribute windows into the
circuit).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# CBOR major types
UNSIGNED = 0
NEGATIVE = 1
BYTES = 2
TEXT = 3
ARRAY = 4
MAP = 5
TAG = 6
PRIMITIVE = 7


@dataclass
class CborDoc:
    t: int = UNSIGNED
    header_pos: int = 0
    u64: int = 0                     # UNSIGNED/NEGATIVE/TAG number/PRIMITIVE
    str_pos: int = 0                 # BYTES/TEXT payload position
    str_len: int = 0
    n_items: int = 0                 # ARRAY/MAP count
    children: List["CborDoc"] = field(default_factory=list)

    # -- accessors (host_decoder.h:67-110) ----------------------------------

    def is_variant(self, t: int) -> bool:
        return self.t == t

    def as_unsigned(self) -> int:
        assert self.t == UNSIGNED
        return self.u64

    def as_bytes(self) -> Tuple[int, int]:
        assert self.t == BYTES
        return self.str_pos, self.str_len

    def as_text(self) -> Tuple[int, int]:
        assert self.t == TEXT
        return self.str_pos, self.str_len

    def as_tag(self) -> int:
        assert self.t == TAG
        return self.u64

    def tagged_value(self) -> "CborDoc":
        assert self.t == TAG
        return self.children[0]

    def text(self, doc: bytes, offset: int = 0) -> bytes:
        assert self.t in (TEXT, BYTES)
        start = self.str_pos - offset
        return doc[start : start + self.str_len]

    # -- lookup (host_decoder.h lookup by text key) -------------------------

    def lookup(self, doc: bytes, key: bytes, offset: int = 0
               ) -> Optional[Tuple["CborDoc", "CborDoc"]]:
        """Map lookup by text key; returns (key_doc, value_doc)."""
        assert self.t == MAP
        for i in range(self.n_items):
            k = self.children[2 * i]
            v = self.children[2 * i + 1]
            if k.t == TEXT and k.text(doc, offset) == key:
                return k, v
        return None

    def lookup_unsigned(self, u: int) -> Optional[Tuple["CborDoc", "CborDoc"]]:
        """Map lookup by unsigned key (host_decoder.h:255-270)."""
        assert self.t == MAP
        for i in range(self.n_items):
            k = self.children[2 * i]
            if k.t == UNSIGNED and k.u64 == u:
                return k, self.children[2 * i + 1]
        return None

    def lookup_negative(self, n: int) -> Optional[Tuple["CborDoc", "CborDoc"]]:
        """Map lookup by NEGATIVE(n) key, i.e. integer -1-n
        (host_decoder.h:272-286)."""
        assert self.t == MAP
        for i in range(self.n_items):
            k = self.children[2 * i]
            if k.t == NEGATIVE and k.u64 == n:
                return k, self.children[2 * i + 1]
        return None

    def index(self, i: int) -> "CborDoc":
        assert self.t in (ARRAY, MAP)
        return self.children[i]

    def position(self) -> int:
        """Value payload position (host_decoder.h:288-308)."""
        if self.t in (UNSIGNED, NEGATIVE, PRIMITIVE):
            return self.header_pos
        if self.t in (BYTES, TEXT):
            return self.str_pos
        if self.t == TAG:
            return self.children[0].str_pos
        raise AssertionError("position() on unknown type")

    def length(self) -> int:
        """Encoded value length in bytes (host_decoder.h:315-344)."""
        if self.t in (UNSIGNED, NEGATIVE):
            v = self.u64
            if v < 24:
                return 1
            if v < 256:
                return 2
            if v < 65536:
                return 3
            return 5
        if self.t in (BYTES, TEXT):
            return self.str_len
        if self.t == TAG:
            return self.children[0].str_len
        if self.t == PRIMITIVE:
            return 1
        raise AssertionError("length() on non-value type")


def _read_count(data: bytes, pos: int, count0: int
                ) -> Optional[Tuple[int, int]]:
    if count0 < 24:
        return count0, pos
    nbytes = {24: 1, 25: 2, 26: 4, 27: 8}.get(count0)
    if nbytes is None or pos + nbytes > len(data):
        return None
    return int.from_bytes(data[pos : pos + nbytes], "big"), pos + nbytes


def decode(data: bytes, pos: int = 0, offset: int = 0,
           max_depth: int = 64) -> Optional[Tuple[CborDoc, int]]:
    """Parse one item at `pos`; returns (doc, new_pos) or None on invalid
    input (host_decoder.h:119-272)."""
    if max_depth == 0 or pos >= len(data):
        return None
    doc = CborDoc(header_pos=pos + offset)
    b = data[pos]
    pos += 1
    major = (b >> 5) & 0x7
    rc = _read_count(data, pos, b & 0x1F)
    if rc is None:
        return None
    count, pos = rc
    doc.t = major
    if major in (UNSIGNED, NEGATIVE):
        doc.u64 = count
    elif major in (BYTES, TEXT):
        if pos + count > len(data):
            return None
        doc.str_pos = pos + offset
        doc.str_len = count
        pos += count
    elif major in (ARRAY, MAP):
        doc.n_items = count
        per = 2 if major == MAP else 1
        if count > len(data):  # cheap DoS guard
            return None
        for _ in range(count * per):
            sub = decode(data, pos, offset, max_depth - 1)
            if sub is None:
                return None
            child, pos = sub
            doc.children.append(child)
    elif major == TAG:
        doc.u64 = count
        sub = decode(data, pos, offset, max_depth - 1)
        if sub is None:
            return None
        child, pos = sub
        doc.children.append(child)
    else:  # PRIMITIVE
        doc.u64 = count
    return doc, pos
