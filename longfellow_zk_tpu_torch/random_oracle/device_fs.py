"""The Fiat-Shamir transcript on the card: K9 (fs_oracle) and K10
(sumcheck_round_tail, and its cubic mode sumcheck_round_tail_cubic for
the plain sumcheck's copy rounds), with their plain PyTorch versions.

Port of the JAX package's random_oracle/device_fs.py:53-399 and of the
oracle part of its device sumcheck (sumcheck/prover_device.py:248
`_write_tagged_elts`, :571-597 `_wire_scan.one_hand`, :543-553
`_copy_scan`).  Byte-exact twin
of the host `Transcript` / `FSPRF` (random_oracle/transcript.py), so the
sumcheck can keep its transcript on the card from `begin_circuit` to the
last layer's write and hand it back to the host once.

The state is two small uint8 tensors, updated in place by every step
(the kernels write them in device memory):

    fs   [104]  the host Transcript's export_state blob: the SHA-256
                midstate h (8 little-endian words), the absorbed byte
                count (8 bytes LE), the partial block (64 bytes; bytes at
                count % 64 and above zero);
    prf  [272]  an FSPRF stream: the AES-256 round keys (240 bytes), the
                current counter block's output (16), the next counter
                (8 bytes LE) and the read pointer into the block (4 LE),
                then 4 zero bytes.  A read that ends a block computes the
                next one at once, as the JAX package's prf_bytes does.

Field elements are tensors in the kernels' form (fields/fp.py,
fields/gf2.py); they are absorbed as their natural little-endian kBytes,
and samples come back in that form (Montgomery for a prime field).

The Ligero column choice (`dev_choose`, the JAX package's dev_nat and
dev_choose, :369-411) is K9 mode 9 CHOOSE: a partial Fisher-Yates walk of
rejection-sampled naturals, with an entry point of its own
(`fs_choose[F.tag]`) so that its launches are counted apart.

Each function takes the field F first: it picks the kernel instance
(`fs_oracle[F.tag]`), and the field-free steps (absorb, getkey, the PRF
bytes) run through it too.  For a CUDA tensor a function launches its
kernel (one launch, a block a lane: csrc/fs.cu spreads a write's layout
and schedules and a draw's counter blocks and tests over the block and
keeps the SHA-256 rounds and the key schedule in one thread;
csrc/round_tail.cu runs a round in one warp; the lanes are the
transcripts of a batch of proofs, zk/batch.py); for a
CPU tensor it runs its plain version (`*_plain`, int64 torch ops; the
SHA-256 compression is merkle/sha256_dev.compress_plain).  The plain
versions read counts and rejection results on the host: they are the
reference the kernels are held to, not a path without syncs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..fields.fp import MUL, ADD, SUB, plain_of, route
from ..merkle.sha256_dev import be_bytes, be_words, compress_plain
from ..utils.crypto import _SBOX

FS_BYTES = 104
PRF_STATE_BYTES = 272

TAG_BSTR = 0
TAG_FIELD_ELEM = 1
TAG_ARRAY = 2

# K9 modes (csrc/fs.cu); mode 9, CHOOSE, has an entry point of its own
# (fs_choose, dev_choose)
(ABSORB, GETKEY, PRF_FRESH, SQUEEZE, PRF_BYTES, WRITE_ARRAY, WRITE_TAGGED,
 SAMPLE, SQUEEZE_SAMPLE) = range(9)


# ----------------------------------------------------------------------
# host <-> device
# ----------------------------------------------------------------------

def fs_init_from_host(ts, device) -> torch.Tensor:
    """The host Transcript's state as an fs tensor on `device`."""
    blob = bytearray(ts.export_state())
    off = int.from_bytes(blob[32:40], "little") % 64
    blob[40 + off :] = bytes(64 - off)
    return torch.frombuffer(blob, dtype=torch.uint8).clone().to(device)


def fs_state_to_host(ts, fs) -> None:
    """Imports a fetched fs state (104 bytes as a numpy array or a CPU
    tensor) into the host Transcript, whose PRF it invalidates."""
    if isinstance(fs, torch.Tensor):
        fs = fs.numpy()
    blob = np.ascontiguousarray(fs, dtype=np.uint8).tobytes()
    assert len(blob) == FS_BYTES
    ts.import_state(blob)


def new_prf(device, lanes: int = None) -> torch.Tensor:
    """An (empty) prf state on `device` ([272], or [lanes, 272]), for a
    squeeze to fill."""
    shape = (PRF_STATE_BYTES,) if lanes is None else (lanes, PRF_STATE_BYTES)
    return torch.zeros(shape, dtype=torch.uint8, device=device)


# ----------------------------------------------------------------------
# plain versions: state parsing
# ----------------------------------------------------------------------

def _le_int(b: torch.Tensor) -> int:
    """Little-endian bytes (a small tensor) -> a host int."""
    return int.from_bytes(bytes(b.to(torch.uint8).cpu().tolist()), "little")


def _le_const(v: int, n: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.tensor(list(int(v).to_bytes(n, "little")),
                        dtype=torch.int64, device=ref.device)


def _le_words(b: torch.Tensor) -> torch.Tensor:
    """int64 bytes [4k] -> int64 [k] little-endian words."""
    x = b.reshape(-1, 4)
    return x[:, 0] | (x[:, 1] << 8) | (x[:, 2] << 16) | (x[:, 3] << 24)


def _le_word_bytes(w: torch.Tensor) -> torch.Tensor:
    return torch.stack([(w >> s) & 0xFF for s in (0, 8, 16, 24)],
                       dim=-1).reshape(-1)


def _fs_parts(fs: torch.Tensor):
    """fs -> (h int64 [8], count, partial block int64 [count % 64])."""
    b = fs.to(torch.int64)
    cnt = _le_int(fs[32:40])
    return _le_words(b[:32]), cnt, b[40 : 40 + cnt % 64]


def _fs_store(fs: torch.Tensor, h, cnt: int, part) -> None:
    blob = torch.cat([_le_word_bytes(h), _le_const(cnt, 8, h), part,
                      torch.zeros(64 - part.numel(), dtype=torch.int64,
                                  device=fs.device)])
    fs.copy_(blob.to(torch.uint8))


def _prf_parts(prf: torch.Tensor):
    """prf -> (round keys int64 [240], saved int64 [16], nb, ptr)."""
    b = prf.to(torch.int64)
    return b[:240], b[240:256], _le_int(prf[256:264]), _le_int(prf[264:268])


def _prf_store(prf: torch.Tensor, rk, saved, nb: int, ptr: int) -> None:
    blob = torch.cat([rk, saved, _le_const(nb, 8, rk), _le_const(ptr, 4, rk),
                      _le_const(0, 4, rk)])
    prf.copy_(blob.to(torch.uint8))


# ----------------------------------------------------------------------
# plain versions: SHA-256 absorb and key, AES-256 CTR
# ----------------------------------------------------------------------

def fs_absorb_plain(F, fs: torch.Tensor, data: torch.Tensor) -> None:
    h, cnt, part = _fs_parts(fs)
    ext = torch.cat([part, data.to(torch.int64).reshape(-1)])
    nfull = ext.numel() // 64
    for i in range(nfull):
        h = compress_plain(h, be_words(ext[64 * i : 64 * i + 64]))
    _fs_store(fs, h, cnt + data.numel(), ext[64 * nfull :])


def fs_getkey_plain(F, fs: torch.Tensor) -> torch.Tensor:
    h, cnt, part = _fs_parts(fs)
    off = part.numel()
    z = torch.zeros(128, dtype=torch.int64, device=fs.device)
    blk = torch.cat([part, torch.full((1,), 0x80, dtype=torch.int64,
                                      device=fs.device), z[: 63 - off]])
    if off >= 56:
        h = compress_plain(h, be_words(blk))
        blk = z[:64]
    blk = torch.cat([blk[:56], _le_const(8 * cnt, 8, blk).flip(0)])
    return be_bytes(compress_plain(h, be_words(blk)))


@functools.lru_cache(maxsize=None)
def _aes_tables(device: str):
    sbox = torch.tensor(list(_SBOX), dtype=torch.int64, device=device)
    # SubBytes + ShiftRows source of byte 4c + r: byte 4((c + r) % 4) + r
    shift = torch.tensor([4 * ((c + r) % 4) + r for c in range(4)
                          for r in range(4)], dtype=torch.int64,
                         device=device)
    return sbox, shift


def _xt(a: torch.Tensor) -> torch.Tensor:
    return ((a << 1) ^ ((a >> 7) * 0x1B)) & 0xFF


def aes256_expand_plain(key: torch.Tensor) -> torch.Tensor:
    """int64 [32] key -> int64 [240] round keys (FIPS-197, Nk = 8)."""
    sbox, _ = _aes_tables(str(key.device))
    w = list(key.to(torch.int64).reshape(8, 4))
    rcon = 1
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = sbox[t.roll(-1)]
            t = torch.cat([t[:1] ^ rcon, t[1:]])
            rcon = ((rcon << 1) ^ (0x1B if rcon & 0x80 else 0)) & 0xFF
        elif i % 8 == 4:
            t = sbox[t]
        w.append(w[i - 8] ^ t)
    return torch.cat(w)


def aes256_blocks_plain(rk: torch.Tensor, nb: int, m: int) -> torch.Tensor:
    """The m counter blocks nb, nb + 1, ... encrypted: int64 [m, 16]."""
    sbox, shift = _aes_tables(str(rk.device))
    ctr = torch.arange(nb, nb + m, dtype=torch.int64, device=rk.device)
    s = torch.cat([torch.stack([(ctr >> (8 * i)) & 0xFF for i in range(8)],
                               dim=-1),
                   torch.zeros((m, 8), dtype=torch.int64, device=rk.device)],
                  dim=-1) ^ rk[:16]
    for r in range(1, 14):
        t = sbox[s[:, shift]].reshape(m, 4, 4)
        a0, a1, a2, a3 = t.unbind(-1)
        x0, x1, x2, x3 = _xt(a0), _xt(a1), _xt(a2), _xt(a3)
        s = torch.stack([x0 ^ x1 ^ a1 ^ a2 ^ a3, a0 ^ x1 ^ x2 ^ a2 ^ a3,
                         a0 ^ a1 ^ x2 ^ x3 ^ a3, x0 ^ a0 ^ a1 ^ a2 ^ x3],
                        dim=-1).reshape(m, 16) ^ rk[16 * r : 16 * r + 16]
    return sbox[s[:, shift]] ^ rk[224:240]


def prf_fresh_plain(F, prf: torch.Tensor, key: torch.Tensor) -> None:
    rk = aes256_expand_plain(key)
    _prf_store(prf, rk, aes256_blocks_plain(rk, 0, 1)[0], 1, 0)


def fs_squeeze_plain(F, fs: torch.Tensor, prf: torch.Tensor) -> None:
    prf_fresh_plain(F, prf, fs_getkey_plain(F, fs))


def prf_bytes_plain(F, prf: torch.Tensor, k: int) -> torch.Tensor:
    rk, saved, nb, ptr = _prf_parts(prf)
    bi = (ptr + k) // 16
    window = torch.cat([saved, aes256_blocks_plain(rk, nb, bi).reshape(-1)])
    _prf_store(prf, rk, window[16 * bi : 16 * bi + 16], nb + bi,
               (ptr + k) % 16)
    return window[ptr : ptr + k].to(torch.uint8)


# ----------------------------------------------------------------------
# plain versions: field elements
# ----------------------------------------------------------------------

def elt_bytes_plain(F, xs: torch.Tensor) -> torch.Tensor:
    """[k, N] elements in the kernels' form -> uint8 [k, kBytes] natural
    little-endian bytes."""
    xs = xs.reshape(-1, F.nlimb)
    if not F.kCharacteristicTwo:
        one = torch.zeros(F.nlimb, dtype=torch.int32, device=xs.device)
        one[0] = 1
        xs = plain_of(F).elementwise_plain(F, MUL, xs, one)
    return xs.contiguous().view(torch.uint8)[:, : F.kBytes]


def fs_write_elts_plain(F, fs: torch.Tensor, xs: torch.Tensor) -> None:
    k = xs.numel() // F.nlimb
    head = torch.cat([torch.full((1,), TAG_ARRAY, dtype=torch.int64,
                                 device=fs.device), _le_const(k, 8, fs)])
    fs_absorb_plain(F, fs, torch.cat([
        head, elt_bytes_plain(F, xs).reshape(-1).to(torch.int64)]))


def write_tagged_elts_plain(F, fs: torch.Tensor, xs: torch.Tensor) -> None:
    body = elt_bytes_plain(F, xs).to(torch.int64)
    tags = torch.full((body.shape[0], 1), TAG_FIELD_ELEM, dtype=torch.int64,
                      device=fs.device)
    fs_absorb_plain(F, fs, torch.cat([tags, body], dim=1).reshape(-1))


def _less_than_p(F, x16: torch.Tensor) -> torch.Tensor:
    """[m, 2N] 16-bit limbs -> bool [m]: the value is below p."""
    borrow = torch.zeros_like(x16[:, 0])
    for i in range(F.nl16):
        d = x16[:, i] - F._p16[i] - borrow
        borrow = (d < 0).to(torch.int64)
    return borrow == 1


def dev_sample_elts_plain(F, prf: torch.Tensor, n: int) -> torch.Tensor:
    """n elements from the stream -> int32 [n, N] in the kernels' form.
    Every attempt takes the same bytes, so the draws of a batch are the
    attempts in stream order; a batch that rejects some is followed by
    one for the rest."""
    if F.kCharacteristicTwo:
        return prf_bytes_plain(F, prf, n * F.kBytes).reshape(
            n, F.kBytes).contiguous().view(torch.int32)
    from ..fields.fp import _const16, _join16, _mont_mul16
    nbytes = (F.exact_bits + 7) // 8
    rem = F.exact_bits % 8
    got, need = [], n
    while need:
        b = prf_bytes_plain(F, prf, need * nbytes).to(torch.int64).reshape(
            need, nbytes)
        if rem:
            b[:, -1] &= (1 << rem) - 1
        b = torch.cat([b, torch.zeros((need, 2 * F.nl16 - nbytes),
                                      dtype=torch.int64, device=b.device)],
                      dim=1)
        x16 = b[:, 0::2] | (b[:, 1::2] << 8)
        ok = _less_than_p(F, x16)
        got.append(x16[ok])
        need -= int(ok.sum())
    x16 = torch.cat(got)
    r2 = _const16(F._r2_16, x16).expand_as(x16)
    return _join16(_mont_mul16(F, x16, r2))


def _newton_at(F, raw, x, consts):
    """raw (the values at the points of consts) interpolated at x in
    Newton's form (poly.eval_lagrange), with the plain products."""
    ew = plain_of(F).elementwise_plain
    pts = [consts[0], consts[1], consts[2], consts[6]][: len(raw)]
    nd = {(1, 1): 3, (2, 1): 4, (2, 2): 5, (3, 1): 7, (3, 2): 8, (3, 3): 9}
    t = list(raw)
    for i in range(1, len(t)):
        for k in range(len(t) - 1, i - 1, -1):
            t[k] = ew(F, MUL, ew(F, SUB, t[k], t[k - 1]), consts[nd[(k, i)]])
    e = t[-1]
    for i in range(len(t) - 2, -1, -1):
        e = ew(F, ADD, ew(F, MUL, e, ew(F, SUB, x, pts[i])), t[i])
    return e


def _tail_plain(F, fs, claim, row, coefs, pad, consts, absorb) -> None:
    """The round polynomial of monomial coefficients `coefs` at the
    points of consts, its evaluations minus the pad absorbed at `absorb`
    (each tagged), the challenge r from a fresh squeeze, the claim
    interpolated at r; row = [the evaluations minus the pad, r]."""
    ew = plain_of(F).elementwise_plain
    pts = [consts[0], consts[1], consts[2], consts[6]][: len(coefs)]
    raw = []
    for x in pts:
        e = coefs[-1]
        for c in coefs[-2::-1]:
            e = ew(F, ADD, ew(F, MUL, e, x), c)
        raw.append(e)
    ev = [ew(F, SUB, r, p) for r, p in zip(raw, pad)]
    write_tagged_elts_plain(F, fs, torch.stack([ev[k] for k in absorb]))
    prf = new_prf(fs.device)
    fs_squeeze_plain(F, fs, prf)
    r = dev_sample_elts_plain(F, prf, 1)[0]
    row.copy_(torch.stack(ev + [r]))
    claim.copy_(_newton_at(F, raw, r, consts))


def round_tail_plain(F, fs, claim, row, a, eq0, pad, consts) -> None:
    """Plain version of K10 (csrc/round_tail.cu): one hand-round's tail;
    fs and claim are updated in place, row [4, N] = [ev0, ev1, ev2, r]."""
    ew = plain_of(F).elementwise_plain
    c0, c2 = ew(F, MUL, eq0, a[0]), ew(F, MUL, eq0, a[1])
    c1 = ew(F, SUB, ew(F, SUB, ew(F, SUB, claim, c0), c0), c2)
    _tail_plain(F, fs, claim, row, [c0, c1, c2], pad, consts, (0, 2))


def round_tail_cubic_plain(F, fs, claim, row, c, pad, consts) -> None:
    """Plain version of K10's cubic mode (csrc/round_tail.cu): one copy
    round's tail from c [3, N] = (c0, c2, c3) of K16; fs and claim are
    updated in place, row [5, N] = [ev0, ev1, ev2, ev3, r]."""
    ew = plain_of(F).elementwise_plain
    c0, c2, c3 = c.unbind(0)
    c1 = claim
    for x in (c0, c0, c2, c3):
        c1 = ew(F, SUB, c1, x)
    _tail_plain(F, fs, claim, row, [c0, c1, c2, c3], pad, consts, (0, 2, 3))


def dev_choose_plain(F, fs: torch.Tensor, prf: torch.Tensor, n: int,
                     k: int) -> torch.Tensor:
    """Plain version of K9 mode 9: a fresh squeeze of fs into prf, then k
    distinct indices in [0, n) (int32 [k]) as Transcript.choose, which
    leave prf where the walk's last draw ended; each draw's bytes are
    read from the stream in turn and compared on the host."""
    fs_squeeze_plain(F, fs, prf)
    A = torch.arange(n, dtype=torch.int64)
    out = torch.empty(k, dtype=torch.int64)
    for i in range(k):
        # Transcript.nat(n - i): l bytes, the least l with n - i < 256^l,
        # masked to the bits of n - i
        bits = (n - i).bit_length()
        l, msk = (bits + 7) // 8, (1 << bits) - 1
        while True:
            b = prf_bytes_plain(F, prf, l).to(torch.int64).cpu()
            r = int((b << (8 * torch.arange(l))).sum()) & msk
            if r < n - i:
                break
        j = i + r
        ai, aj = int(A[i]), int(A[j])
        A[i], A[j] = aj, ai
        out[i] = aj
    return out.to(torch.int32).to(prf.device)


# ----------------------------------------------------------------------
# wrappers: the kernel for a CUDA tensor, the plain version for a CPU one
# ----------------------------------------------------------------------
#
# Every step takes one transcript (fs [104], prf [272]) or a lane axis of
# them (fs [B, 104], prf [B, 272]: the proofs of a batch), and then gives
# its outputs and takes its per-lane inputs with that leading axis.  The
# kernels run the lanes in one launch, one block each; the plain versions
# run them one after another.

def _lanes(t: torch.Tensor, nbytes: int, name: str) -> int:
    """The lanes of a state tensor: 1 for [nbytes], B for [B, nbytes]."""
    if t.dtype != torch.uint8 or t.dim() not in (1, 2) or \
            t.shape[-1] != nbytes or not t.is_contiguous():
        raise ValueError("%s must be a contiguous uint8 [%d] or [B, %d] "
                         "tensor" % (name, nbytes, nbytes))
    return 1 if t.dim() == 1 else t.shape[0]


def _lanes_of(*states) -> int:
    """The lanes of (tensor, nbytes, name) states, which must agree."""
    got = {(_lanes(t, nb, nm), t.dim()) for t, nb, nm in states
           if t is not None}
    if len(got) != 1:
        raise ValueError("the states' lanes differ: %s" % sorted(got))
    return got.pop()[0]


def _each(state: torch.Tensor, fn, *per_lane):
    """fn(b, *(x[b] for x in per_lane)) for each lane b of `state`, or
    fn(None, *per_lane) once for a state without a lane axis; the results
    stacked (None for steps that only update the states)."""
    if state.dim() == 1:
        return fn(None, *per_lane)
    out = [fn(b, *(x[b] for x in per_lane)) for b in range(state.shape[0])]
    return None if out[0] is None else torch.stack(out)


def _elts(F, xs: torch.Tensor, name: str) -> torch.Tensor:
    if xs.dtype != torch.int32 or xs.shape[-1] != F.nlimb:
        raise ValueError("%s must be an int32 [..., %d] tensor"
                         % (name, F.nlimb))
    return xs.contiguous()


def _k9(name: str, mode: int, lanes: int, fs, prf, inp, out, n: int,
        in_stride: int = 0, out_stride: int = 0) -> None:
    """One K9 launch over `lanes` lanes; the strides are the bytes between
    lanes of inp and out (0: shared)."""
    kernels.launch(name, 1, mode, *[0 if t is None else t.data_ptr()
                                    for t in (fs, prf, inp, out)], n, lanes,
                   in_stride, out_stride)


def fs_absorb(F, fs: torch.Tensor, data: torch.Tensor) -> None:
    """fs absorbs the bytes of data (uint8 [n], shared by the lanes, or
    [B, n], one row a lane), untyped."""
    B = _lanes(fs, FS_BYTES, "fs")
    if data.dtype != torch.uint8 or data.dim() > fs.dim() or \
            (data.dim() == 2 and data.shape[0] != B):
        raise ValueError("data must be a uint8 [n] or [B, n] tensor")
    data = data.contiguous()
    name = route("fs_oracle", F, fs, data)
    if name is None:
        return _each(fs, lambda b, f: fs_absorb_plain(
            F, f, data if data.dim() == 1 else data[b]), fs)
    n = data.shape[-1]
    _k9(name, ABSORB, B, fs, None, data, None, n,
        in_stride=n if data.dim() == 2 else 0)


def fs_getkey(F, fs: torch.Tensor) -> torch.Tensor:
    """The 32-byte key of the transcript (the digest of a copy): [32], or
    [B, 32]."""
    B = _lanes(fs, FS_BYTES, "fs")
    name = route("fs_oracle", F, fs)
    if name is None:
        return _each(fs, lambda b, f: fs_getkey_plain(F, f), fs)
    out = torch.empty(fs.shape[:-1] + (32,), dtype=torch.uint8,
                      device=fs.device)
    _k9(name, GETKEY, B, fs, None, None, out, 0, out_stride=32)
    return out


def prf_fresh(F, prf: torch.Tensor, key: torch.Tensor) -> None:
    """prf becomes a fresh stream under the 32-byte key (uint8; [B, 32]
    for lanes)."""
    B = _lanes(prf, PRF_STATE_BYTES, "prf")
    if key.dtype != torch.uint8 or tuple(key.shape) != \
            tuple(prf.shape[:-1]) + (32,):
        raise ValueError("key must be uint8 [32], or [B, 32] for lanes")
    key = key.contiguous()
    name = route("fs_oracle", F, prf, key)
    if name is None:
        return _each(prf, lambda b, p, k: prf_fresh_plain(F, p, k), prf, key)
    _k9(name, PRF_FRESH, B, None, prf, key, None, 0, in_stride=32)


def fs_squeeze(F, fs: torch.Tensor, prf: torch.Tensor) -> None:
    """prf becomes a fresh stream keyed by the transcript."""
    B = _lanes_of((fs, FS_BYTES, "fs"), (prf, PRF_STATE_BYTES, "prf"))
    name = route("fs_oracle", F, fs, prf)
    if name is None:
        return _each(fs, lambda b, f, p: fs_squeeze_plain(F, f, p), fs, prf)
    _k9(name, SQUEEZE, B, fs, prf, None, None, 0)


def prf_bytes(F, prf: torch.Tensor, k: int) -> torch.Tensor:
    """The next k bytes of the stream (uint8 [k], or [B, k])."""
    B = _lanes(prf, PRF_STATE_BYTES, "prf")
    name = route("fs_oracle", F, prf)
    if name is None:
        return _each(prf, lambda b, p: prf_bytes_plain(F, p, k), prf)
    out = torch.empty(prf.shape[:-1] + (k,), dtype=torch.uint8,
                      device=prf.device)
    _k9(name, PRF_BYTES, B, None, prf, None, out, k, out_stride=k)
    return out


def bstr_tensor(data: bytes, device) -> torch.Tensor:
    """The bytes Transcript.write_bytes(data) absorbs, [TAG_BSTR, le8(len),
    data], as a uint8 tensor on `device` for fs_absorb (the JAX package's
    fs_write_bytes_const, device_fs.py:240): a caller that must not wait
    on the card inside its window uploads them before it."""
    blob = bytes([TAG_BSTR]) + len(data).to_bytes(8, "little") + data
    return torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(device)


def _write(F, mode: int, plain, fs: torch.Tensor, xs: torch.Tensor) -> None:
    B = _lanes(fs, FS_BYTES, "fs")
    xs = _elts(F, xs, "xs")
    if fs.dim() == 2 and (xs.dim() < 2 or xs.shape[0] != B):
        raise ValueError("xs needs the lane axis of fs")
    name = route("fs_oracle", F, fs, xs)
    if name is None:
        return _each(fs, lambda b, f, x: plain(F, f, x), fs, xs)
    k = xs[0].numel() // F.nlimb if fs.dim() == 2 else \
        xs.numel() // F.nlimb
    _k9(name, mode, B, fs, None, xs, None, k, in_stride=4 * F.nlimb * k)


def fs_write_elts(F, fs: torch.Tensor, xs: torch.Tensor) -> None:
    """fs absorbs xs ([k, N]; [B, k, N] for lanes) as one tagged array a
    lane (Transcript.write_elts)."""
    _write(F, WRITE_ARRAY, fs_write_elts_plain, fs, xs)


def write_tagged_elts(F, fs: torch.Tensor, xs: torch.Tensor) -> None:
    """fs absorbs the k elements of xs ([k, N]; [B, k, N] for lanes), each
    tagged, in one step (k calls of Transcript.write_elt)."""
    _write(F, WRITE_TAGGED, write_tagged_elts_plain, fs, xs)


def dev_sample_elts(F, prf: torch.Tensor, n: int,
                    fs: torch.Tensor = None) -> torch.Tensor:
    """n elements ([n, N], the kernels' form; [B, n, N] for lanes) from
    the stream prf, by rejection as Transcript.elt; with fs, prf is first
    squeezed fresh from it (one launch for both).  Lanes that reject draw
    more bytes of their own streams."""
    B = _lanes_of((prf, PRF_STATE_BYTES, "prf"), (fs, FS_BYTES, "fs"))
    name = route("fs_oracle", F, *((prf,) if fs is None else (prf, fs)))
    if name is None:
        def one(b, p):
            if fs is not None:
                fs_squeeze_plain(F, fs if b is None else fs[b], p)
            return dev_sample_elts_plain(F, p, n)
        return _each(prf, one, prf)
    out = torch.empty(prf.shape[:-1] + (n, F.nlimb), dtype=torch.int32,
                      device=prf.device)
    _k9(name, SAMPLE if fs is None else SQUEEZE_SAMPLE, B, fs, prf, None, out,
        n, out_stride=4 * F.nlimb * n)
    return out


def dev_choose(F, fs: torch.Tensor, prf: torch.Tensor, n: int,
               k: int) -> torch.Tensor:
    """K9 mode 9, one launch: a fresh squeeze of fs into prf, then k
    distinct indices in [0, n) (int32 [k]; [B, k] for lanes, each from
    its own stream) by the partial Fisher-Yates walk of Transcript.choose,
    each step a rejection sample of Transcript.nat(n - i); prf is left
    where the walk ended."""
    B = _lanes_of((fs, FS_BYTES, "fs"), (prf, PRF_STATE_BYTES, "prf"))
    if not 0 < k <= n < 2**31:
        raise ValueError("choose needs 0 < k <= n < 2^31, got %d, %d"
                         % (k, n))
    name = route("fs_choose", F, fs, prf)
    if name is None:
        return _each(fs, lambda b, f, p: dev_choose_plain(F, f, p, n, k),
                     fs, prf)
    # a lane's k indices, then its walk's array of n (when it does not fit
    # in shared memory)
    out = torch.empty(fs.shape[:-1] + (k + n,), dtype=torch.int32,
                      device=prf.device)
    kernels.launch(name, 1, fs.data_ptr(), prf.data_ptr(), out.data_ptr(),
                   k, n, B)
    return out[..., :k]


def dev_sample_elt(F, prf: torch.Tensor) -> torch.Tensor:
    """One element ([N]) from the stream prf."""
    return dev_sample_elts(F, prf, 1)[0]


def _rows(t: torch.Tensor, nm: str, lanes: int, n: int, N: int) -> int:
    """The lane stride (elements) of t, [lanes, n, N] with each lane's
    [n, N] contiguous (a view into a per-layer tensor)."""
    if t.dtype != torch.int32 or tuple(t.shape) != (lanes, n, N) or \
            t.stride(2) != 1 or t.stride(1) != N or t.stride(0) % N:
        raise ValueError("%s must be int32 [%d, %d, %d] with contiguous "
                         "lanes, got %s" % (nm, lanes, n, N, tuple(t.shape)))
    return t.stride(0) // N


def _tail_args(F, fs, claim, row, a, pad, consts, na: int, nrow: int):
    """Checks a round tail's arguments ([B]-lane or one transcript, a with
    na elements a lane, row and pad with nrow and nrow - 1) and returns
    (lanes, row stride, pad stride)."""
    B = _lanes(fs, FS_BYTES, "fs")
    N = F.nlimb
    one = fs.dim() == 1
    lead = () if one else (B,)
    for t, nm, shape in ((claim, "claim", lead + (N,)),
                         (a, "a", lead + (na, N)),
                         (consts, "consts", (10, N))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError("%s must be a contiguous int32 %s tensor"
                             % (nm, list(shape)))
    return (B, _rows(row[None] if one else row, "row", B, nrow, N),
            _rows(pad[None] if one else pad, "pad", B, nrow - 1, N))


def round_tail(F, fs: torch.Tensor, claim: torch.Tensor, row: torch.Tensor,
               a: torch.Tensor, eq0: torch.Tensor, pad: torch.Tensor,
               consts: torch.Tensor) -> None:
    """K10: the tail of one sumcheck hand-round (csrc/round_tail.cu).
    a [2, N] = (a0, a2) from K3, eq0 [N], pad [3, N] the round's pad
    evaluations, consts [10, N] (fields/fp.round_consts); updates fs and
    claim [N] in place and writes row [4, N] = [ev0, ev1, ev2, r].  For
    lanes, fs [B, 104], claim [B, N], a [B, 2, N], and row [B, 4, N] and
    pad [B, 3, N] may be views whose lanes lie apart (eq0 and consts are
    shared); one launch runs every lane."""
    B, row_s, pad_s = _tail_args(F, fs, claim, row, a, pad, consts, 2, 4)
    if eq0.dtype != torch.int32 or tuple(eq0.shape) != (F.nlimb,) or \
            not eq0.is_contiguous():
        raise ValueError("eq0 must be a contiguous int32 [%d] tensor"
                         % F.nlimb)
    name = route("sumcheck_round_tail", F, fs, claim, row, a, eq0, pad,
                 consts)
    if name is None:
        return _each(fs, lambda b, f, c, r, x, p: round_tail_plain(
            F, f, c, r, x, eq0, p, consts), fs, claim, row, a, pad)
    kernels.launch(name, 1, fs.data_ptr(), claim.data_ptr(), row.data_ptr(),
                   a.data_ptr(), eq0.data_ptr(), pad.data_ptr(),
                   consts.data_ptr(), B, row_s, pad_s)


def round_tail_cubic(F, fs: torch.Tensor, claim: torch.Tensor,
                     row: torch.Tensor, c: torch.Tensor, pad: torch.Tensor,
                     consts: torch.Tensor) -> None:
    """K10's cubic mode: the tail of one copy round of the plain sumcheck
    (csrc/round_tail.cu).  c [3, N] = (c0, c2, c3) from K16, pad [4, N]
    the round's pad evaluations, consts [10, N] (fields/fp.round_consts);
    updates fs and claim [N] in place and writes row [5, N] = [ev0, ev1,
    ev2, ev3, r].  Lanes as in round_tail (fs [B, 104], claim [B, N], c
    [B, 3, N], row [B, 5, N] and pad [B, 4, N] views), one launch."""
    B, row_s, pad_s = _tail_args(F, fs, claim, row, c, pad, consts, 3, 5)
    name = route("sumcheck_round_tail_cubic", F, fs, claim, row, c, pad,
                 consts)
    if name is None:
        return _each(fs, lambda b, f, cl, r, x, p: round_tail_cubic_plain(
            F, f, cl, r, x, p, consts), fs, claim, row, c, pad)
    kernels.launch(name, 1, fs.data_ptr(), claim.data_ptr(), row.data_ptr(),
                   c.data_ptr(), pad.data_ptr(), consts.data_ptr(), B, row_s,
                   pad_s)
