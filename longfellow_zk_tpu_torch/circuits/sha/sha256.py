"""Host witness of the flat SHA-256 circuit (reference
lib/circuits/sha/flatsha256_witness): the padded message, each round's
message-schedule word w, working values e and a, and the chained digest
h1, packed four bits to a field element by the bit plucker encoder
(reference bit_plucker_encoder.h, compiler/components.py).  Copied from
the JAX package's circuits/sha/sha256.py; the circuit itself is read
from its LFC1 file (artifacts/sha256_1block_fp128.lfc1.gz).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ...compiler.components import BitPluckerEncoder

K_SHA256_ROUND = [
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
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

SHA256_INIT = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
               0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


@dataclass
class ShaBlockWitness:
    outw: List[int]  # [48]
    oute: List[int]  # [64]
    outa: List[int]  # [64]
    h1: List[int]    # [8]


def sha256_pad(message: bytes) -> bytes:
    """Standard SHA-256 padding."""
    ml = len(message) * 8
    out = message + b"\x80"
    while len(out) % 64 != 56:
        out += b"\x00"
    return out + ml.to_bytes(8, "big")


def transform_block_witness(H0: Sequence[int], block: bytes) -> ShaBlockWitness:
    w = list(int.from_bytes(block[4 * i : 4 * i + 4], "big") for i in range(16))
    outw = []
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & 0xFFFFFFFF)
        outw.append(w[-1])
    a, b, c, d, e, f, g, h = H0
    oute, outa = [], []
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = ((e & f) ^ ((~e) & g)) & 0xFFFFFFFF
        t1 = (h + S1 + ch + K_SHA256_ROUND[t] + w[t]) & 0xFFFFFFFF
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = ((a & b) ^ (a & c) ^ (b & c)) & 0xFFFFFFFF
        t2 = (S0 + maj) & 0xFFFFFFFF
        h, g, f = g, f, e
        e = (d + t1) & 0xFFFFFFFF
        d, c, b = c, b, a
        a = (t1 + t2) & 0xFFFFFFFF
        oute.append(e)
        outa.append(a)
    h1 = [(x + y) & 0xFFFFFFFF for x, y in zip(H0, [a, b, c, d, e, f, g, h])]
    return ShaBlockWitness(outw=outw, oute=oute, outa=outa, h1=h1)


def message_witness(message: bytes, max_blocks: int):
    """Returns (nb, padded bytes [64*max], block witnesses [max], digest)."""
    padded = sha256_pad(message)
    nb = len(padded) // 64
    assert nb <= max_blocks
    # Dummy blocks past nb keep chaining through h1 over zero data
    # (flatsha256_witness.cc:155-164): the circuit asserts the transform
    # equations for every block, real or padding.
    padded_full = padded + b"\x00" * (64 * (max_blocks - nb))
    H = list(SHA256_INIT)
    bws = []
    digest = None
    for b in range(max_blocks):
        bw = transform_block_witness(H, padded_full[64 * b : 64 * (b + 1)])
        bws.append(bw)
        H = bw.h1
        if b == nb - 1:
            digest = b"".join(x.to_bytes(4, "big") for x in H)
    return nb, padded_full, bws, digest

def pack_block_witness(F, plucker_logn: int, bws: Sequence[ShaBlockWitness]
                       ) -> List:
    """Host field elements in circuit input order for each block witness."""
    enc = BitPluckerEncoder(F, plucker_logn)
    out = []
    for bw in bws:
        for v in bw.outw:
            out.extend(enc.mkpacked_v32(v))
        for i in range(64):
            out.extend(enc.mkpacked_v32(bw.oute[i]))
            out.extend(enc.mkpacked_v32(bw.outa[i]))
        for v in bw.h1:
            out.extend(enc.mkpacked_v32(v))
    return out
