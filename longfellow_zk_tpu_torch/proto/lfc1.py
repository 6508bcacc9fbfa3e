"""LFC1 circuit wire format reader and circuit_id.

Byte-exact twin of reference lib/proto/circuit_{io,reader,writer}.h and
lib/sumcheck/circuit_id.h: version byte 1, 3-byte little-endian sizes,
constant table (deduplicated field elements), per-layer quad terms with
sign-bit delta-encoded indices, trailing 32-byte circuit id (SHA-256 of
the canonical structure).  Reading the LFC1 files shipped with the
reference lets every reference circuit (incl. the prebuilt mdoc
circuits) run on this framework unchanged.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

from ..sumcheck.circuit import Circuit, Layer, Quad
from ..utils.serialization import ReadBuffer

BYTES_PER_SIZE_T = 3
ID_SIZE = 32
MAX_LAYERS = 10000
MAX_VALUE = (1 << (8 * BYTES_PER_SIZE_T)) - 1
MAX_VALID_WIRE_ID = 0xFFFFFFFE
MAX_VALID_INDEX = 0xFFFFFFFF

# FieldID enum (circuit_io.h:24-36)
NONE_ID = 0
P256_ID = 1
P384_ID = 2
P521_ID = 3
GF2_128_ID = 4
GF2_16_ID = 5
FP128_ID = 6
FP64_ID = 7
GOLDI_ID = 8
FP64_2_ID = 9
SECP_ID = 10


def lg(n: int) -> int:
    """ceil(log2(n)) (util/ceildiv.h:36)."""
    assert n > 0
    lgn = 0
    while n > 1:
        n = (n // 2) + (n % 2)
        lgn += 1
    return lgn


def _read_num(buf: ReadBuffer) -> int:
    b = buf.bytes(BYTES_PER_SIZE_T)
    return int.from_bytes(b, "little")


def _read_index(buf: ReadBuffer, prev: int) -> int:
    delta = _read_num(buf)
    if delta & 1:
        return prev - (delta >> 1)
    return prev + (delta >> 1)


def read_circuit(F, field_id: int, data: bytes,
                 enforce_circuit_id: bool = False) -> Optional[Circuit]:
    """(circuit_reader.h:55-219).

    Falls back to the legacy header without the subfield_boundary field
    (used e.g. by the docs/specs/testvectors.md circuit vector) when the
    current header fails to parse.
    """
    c = _read_circuit(F, field_id, ReadBuffer(data), enforce_circuit_id,
                      legacy=False, whole=True)
    if c is None:
        c = _read_circuit(F, field_id, ReadBuffer(data), enforce_circuit_id,
                          legacy=True, whole=True)
    return c


def read_circuit_buf(F, field_id: int, buf: ReadBuffer,
                     enforce_circuit_id: bool = False) -> Optional[Circuit]:
    """Sequential read from a shared buffer (multiple circuits back to
    back, as in the reference's compressed mdoc circuit files:
    mdoc_zk.cc:439-462 reads sig then hash from one ReadBuffer)."""
    return _read_circuit(F, field_id, buf, enforce_circuit_id,
                         legacy=False, whole=False)


def _read_circuit(F, field_id: int, buf: ReadBuffer, enforce_circuit_id: bool,
                  legacy: bool, whole: bool) -> Optional[Circuit]:
    try:
        version = buf.u8()
        if version != 1:
            return None
        fid = _read_num(buf)
        nv = _read_num(buf)
        nc = _read_num(buf)
        npub_in = _read_num(buf)
        subfield_boundary = 0 if legacy else _read_num(buf)
        ninputs = _read_num(buf)
        nl = _read_num(buf)
        numconst = _read_num(buf)
        if (nv == 0 or nv > MAX_VALID_WIRE_ID or nc == 0 or nl == 0
                or nl > MAX_LAYERS or fid != field_id
                or ninputs > MAX_VALID_WIRE_ID or npub_in > ninputs
                or subfield_boundary > ninputs or numconst > MAX_VALID_INDEX):
            return None
        constants = []
        for _ in range(numconst):
            v = F.of_bytes(buf.bytes(F.kBytes))
            if v is None:
                return None
            constants.append(v)
        circ = Circuit(nv=nv, logv=lg(nv), nc=nc, logc=lg(nc), nl=nl,
                       ninputs=ninputs, npub_in=npub_in,
                       subfield_boundary=subfield_boundary, layers=[])
        max_g = nv
        for _ in range(nl):
            lw = _read_num(buf)
            if lw > 40 or lw == 0:
                return None
            nw = _read_num(buf)
            if nw == 0 or nw < lw or nw > MAX_VALID_WIRE_ID or nw > (1 << lw):
                return None
            nq = _read_num(buf)
            if nq == 0 or nq > MAX_VALID_INDEX:
                return None
            # vectorized term block parse: terms are fixed 12-byte records
            # (3 sign-bit delta-encoded indices + constant-table index)
            raw = np.frombuffer(buf.bytes(12 * nq), dtype=np.uint8)
            raw = raw.reshape(nq, 12)

            def _num3(o):
                v = raw[:, o].astype(np.uint32)
                v |= raw[:, o + 1].astype(np.uint32) << 8
                v |= raw[:, o + 2].astype(np.uint32) << 16
                return v

            def _undelta(d):
                mag = (d >> 1).astype(np.int64)
                signed = np.where(d & 1, -mag, mag)
                return np.cumsum(signed)

            g = _undelta(_num3(0))
            h0 = _undelta(_num3(3))
            h1 = _undelta(_num3(6))
            kidx = _num3(9)
            if (g.min() < 0 or g.max() >= max_g or h0.min() < 0
                    or h0.max() >= nw or h1.min() < 0 or h1.max() >= nw
                    or kidx.max() >= numconst):
                return None
            circ.layers.append(Layer(nw=nw, logw=lw,
                                     quad=Quad(g=g, h0=h0, h1=h1,
                                               kidx=kidx.astype(np.int64),
                                               ktable=constants)))
            max_g = nw
        if legacy and buf.remaining() == 0:
            # legacy serializations (e.g. the spec test vector) carry no id
            circ.id = b"\x00" * ID_SIZE
        else:
            circ.id = buf.bytes(ID_SIZE)
            if whole and buf.remaining() != 0:
                return None
    except ValueError:
        return None
    if enforce_circuit_id and circuit_id(F, circ) != circ.id:
        return None
    return circ


def circuit_id(F, circ: Circuit) -> bytes:
    """Canonical SHA-256 of the circuit structure
    (sumcheck/circuit_id.h:29-67)."""
    sha = hashlib.sha256()

    def u8(x: int):
        sha.update(int(x).to_bytes(8, "little"))

    if F.kCharacteristicTwo:
        u8(2)
        u8(F.kBits)
    else:
        u8(1)
        sha.update(F.to_bytes(F.p - 1))  # -1 determines the prime field
    u8(circ.nv)
    u8(circ.logv)
    u8(circ.nc)
    u8(circ.logc)
    u8(circ.nl)
    u8(circ.ninputs)
    u8(circ.npub_in)
    u8(circ.subfield_boundary)
    for layer in circ.layers:
        u8(layer.nw)
        u8(layer.logw)
        u8(layer.quad.nterms)
        q = layer.quad
        # vectorized: [u64 g | u64 h0 | u64 h1 | kBytes v] per term
        nq = q.nterms
        rec = 24 + F.kBytes
        block = np.zeros((nq, rec), dtype=np.uint8)
        idx = np.stack([np.asarray(q.g, np.uint64),
                        np.asarray(q.h0, np.uint64),
                        np.asarray(q.h1, np.uint64)], axis=1)
        block[:, :24] = idx.astype("<u8").view(np.uint8).reshape(nq, 24)
        if q.kidx is not None:
            tbl = np.frombuffer(
                b"".join(F.to_bytes(x) for x in q.ktable),
                dtype=np.uint8).reshape(len(q.ktable), F.kBytes)
            block[:, 24:] = tbl[q.kidx]
        else:
            vb = b"".join(F.to_bytes(x) for x in q.v)
            block[:, 24:] = np.frombuffer(vb, np.uint8).reshape(nq, F.kBytes)
        sha.update(block.tobytes())
    return sha.digest()
