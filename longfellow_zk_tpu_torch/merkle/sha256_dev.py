"""Batched SHA-256 of equal-length messages: K8 on the card, its plain
version on the CPU.

Port of the JAX package's merkle/sha256_jax.py (`_compress`,
`sha256_words`) and merkle/merkle_jax.py:29-54 (`pad_blocks_dev`,
`sha256_msgs_dev`).  The Ligero commit hashes one message per tableau
column (the 32-byte nonce, then the column's serialized elements), all of
one length, and the Merkle tree one 64-byte message per node of a level.

`sha256_msgs` pads in torch on the messages' device (the 0x80 byte,
zeros and the 64-bit big-endian bit length, as `pad_blocks_dev`), then
launches K8 (csrc/sha256.cu, one thread a message) for a CUDA tensor and
runs `sha256_msgs_plain` for a CPU one.  The plain version is SHA-256
over int64 torch tensors masked to 32 bits, batched over the messages
(CPU PyTorch has no uint32 shifts).
"""

from __future__ import annotations

import functools

import torch

from .. import kernels

M32 = 0xFFFFFFFF
DIGEST_LEN = 32

_K = (
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

H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)


def padded_len(mlen: int) -> int:
    """Bytes of a padded message of mlen bytes: a multiple of 64."""
    return (mlen + 9 + 63) // 64 * 64


@functools.lru_cache(maxsize=None)
def _tail(mlen: int, device: str) -> torch.Tensor:
    """The padding of an mlen-byte message (uploaded once per length)."""
    n = padded_len(mlen) - mlen
    tail = bytearray(n)
    tail[0] = 0x80
    tail[-8:] = (8 * mlen).to_bytes(8, "big")
    return torch.frombuffer(tail, dtype=torch.uint8).to(device)


def pad_messages(msgs: torch.Tensor) -> torch.Tensor:
    """uint8 [n, mlen] -> uint8 [n, padded_len(mlen)] padded messages."""
    n, mlen = msgs.shape
    tail = _tail(mlen, str(msgs.device))
    return torch.cat([msgs, tail.expand(n, tail.shape[0])], dim=1)


# ----------------------------------------------------------------------
# plain version: int64 words masked to 32 bits
# ----------------------------------------------------------------------

def be_words(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 4k] -> int64 [..., k] big-endian words."""
    x = b.to(torch.int64).reshape(b.shape[:-1] + (b.shape[-1] // 4, 4))
    return (x[..., 0] << 24) | (x[..., 1] << 16) | (x[..., 2] << 8) | \
        x[..., 3]


def be_bytes(w: torch.Tensor) -> torch.Tensor:
    """int64 [..., k] words -> uint8 [..., 4k] big-endian bytes."""
    b = torch.stack([(w >> s) & 0xFF for s in (24, 16, 8, 0)], dim=-1)
    return b.reshape(w.shape[:-1] + (4 * w.shape[-1],)).to(torch.uint8)


def _sigma(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3) of 32-bit words x: the
    word doubled into 64 bits, so a rotation is a shift (bits that a
    shift moves past bit 31 are masked off, the sign bits too)."""
    d = x | (x << 32)
    return ((d >> r1) ^ (d >> r2) ^ (d >> r3)) & M32


def _gamma(x: torch.Tensor, r1: int, r2: int, s: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> s): the schedule's sigmas."""
    d = x | (x << 32)
    return (((d >> r1) ^ (d >> r2)) & M32) ^ (x >> s)


def compress_plain(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One compression: h int64 [..., 8], w int64 [..., 16] big-endian
    message words -> the new h [..., 8]."""
    w = list(w.unbind(-1))
    for i in range(16, 64):
        w.append((w[i - 16] + _gamma(w[i - 15], 7, 18, 3) + w[i - 7] +
                  _gamma(w[i - 2], 17, 19, 10)) & M32)
    a, b, c, d, e, f, g, hh = h.unbind(-1)
    for i in range(64):
        t1 = hh + _sigma(e, 6, 11, 25) + (g ^ (e & (f ^ g))) + \
            (w[i] + _K[i])
        maj = (a & b) | (c & (a | b))
        hh, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32, c, b, a,
                                   (t1 + _sigma(a, 2, 13, 22) + maj) & M32)
    return (h + torch.stack([a, b, c, d, e, f, g, hh], dim=-1)) & M32


def sha256_msgs_plain(msgs: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: uint8 [n, mlen] -> uint8 [n, 32]."""
    w = be_words(pad_messages(msgs))
    h = torch.tensor(H0, dtype=torch.int64,
                     device=msgs.device).expand(msgs.shape[0], 8)
    for blk in range(w.shape[1] // 16):
        h = compress_plain(h, w[:, 16 * blk : 16 * blk + 16])
    return be_bytes(h)


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------

def sha256_msgs(msgs: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each row of msgs (uint8 [n, mlen]) -> uint8 [n, 32]:
    K8 for a CUDA tensor, the plain version for a CPU one."""
    if msgs.dtype != torch.uint8 or msgs.dim() != 2:
        raise ValueError("msgs must be a uint8 [n, mlen] tensor, got %s %s"
                         % (msgs.dtype, tuple(msgs.shape)))
    if msgs.device.type == "cpu":
        return sha256_msgs_plain(msgs)
    if msgs.device.type != "cuda":
        raise ValueError("unsupported device %s" % msgs.device)
    n = msgs.shape[0]
    padded = pad_messages(msgs).contiguous()
    out = torch.empty((n, DIGEST_LEN), dtype=torch.uint8, device=msgs.device)
    kernels.launch("sha256_msgs[bytes]", 1, out.data_ptr(), padded.data_ptr(),
                   n, padded.shape[1] // 64)
    return out
