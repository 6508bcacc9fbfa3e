"""Host-side mdoc witness builders (copied from the JAX package's
circuits/mdoc/witness.py).

Semantic twin of reference lib/circuits/mdoc/mdoc_witness.h:30-918:
parse the DeviceResponse CBOR, locate the MSO and attribute windows,
compute the SHA-256/ECDSA/MAC witnesses, and emit the wire assignments
in the exact input order of the mdoc circuits (both ours and the
reference-shipped LFC1 circuits — the layouts are identical, which is
what lets this framework drive the prebuilt circuit files).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ...compiler.components import BitPluckerEncoder
from ..cbor import host_decoder as hd
from ..ecdsa.verify import compute_witness as ecdsa_witness
from ..mac.mac import mac_witness_values
from ..sha.sha256 import (SHA256_INIT, ShaBlockWitness, sha256_pad,
                          transform_block_witness)
from . import constants as C


class MdocError(Exception):
    def __init__(self, code: str):
        super().__init__(code)
        self.code = code


@dataclass
class CborIndex:
    k: int = 0
    v: int = 0
    pos: int = 0
    len: int = 0


@dataclass
class FullAttribute:
    id_ind: int = 0
    id_len: int = 0
    val_ind: int = 0
    val_len: int = 0
    dig_ind: int = 0
    dig_len: int = 0
    rand_ind: int = 0
    rand_len: int = 0
    namespace: bytes = b""
    digest_id: int = 0
    mso: CborIndex = field(default_factory=CborIndex)
    tag_ind: int = 0
    tag_len: int = 0


@dataclass
class RequestedAttribute:
    """Public API struct (mdoc_zk.h RequestedAttribute)."""

    namespace_id: bytes = b"org.iso.18013.5.1"
    id: bytes = b""
    cbor_value: bytes = b""


def _copy_kv(ind: CborIndex, k: hd.CborDoc, v: hd.CborDoc) -> None:
    ind.k = k.header_pos
    ind.v = v.header_pos
    if v.t in (hd.TEXT, hd.BYTES):
        ind.pos = v.str_pos
        ind.len = v.str_len


class ParsedMdoc:
    """(mdoc_witness.h:102-377)."""

    def __init__(self):
        self.t_mso = CborIndex()
        self.sig = CborIndex()
        self.dksig = CborIndex()
        self.valid_from = CborIndex()
        self.valid_until = CborIndex()
        self.dev_key_info = CborIndex()
        self.dev_key_pkx = CborIndex()
        self.dev_key_pky = CborIndex()
        self.value_digests = CborIndex()
        self.attributes: List[FullAttribute] = []
        self.doc_type = b""
        self.tagged_mso_bytes = b""

    def parse_device_response(self, resp: bytes) -> None:
        out = hd.decode(resp, 0)
        if out is None:
            raise MdocError("ROOT_DECODING_FAILURE")
        root, _ = out

        def need(x, code):
            if x is None:
                raise MdocError(code)
            return x

        docs = need(root.lookup(resp, b"documents"), "DOCUMENTS_MISSING")[1]
        docs0 = docs.index(0)
        dt = need(docs0.lookup(resp, b"docType"), "DOCTYPE_MISSING")[1]
        self.doc_type = dt.text(resp)
        isd = need(docs0.lookup(resp, b"issuerSigned"),
                   "ISSUER_SIGNED_MISSING")[1]
        ia = need(isd.lookup(resp, b"issuerAuth"), "ISSUER_AUTH_MISSING")[1]
        tmso = ia.index(2)
        self._copy_header(self.t_mso, tmso)
        nsig = ia.index(3)
        self._copy_header(self.sig, nsig)

        ns = need(isd.lookup(resp, b"nameSpaces"), "NAMESPACES_MISSING")[1]
        for sn in C.K_SUPPORTED_NAMESPACES:
            found = ns.lookup(resp, sn)
            if found is None:
                continue
            arr = found[1]
            if not arr.is_variant(hd.ARRAY):
                raise MdocError("NAMESPACES_MISSING")
            for ai in range(arr.n_items):
                tattr = arr.index(ai)
                if not tattr.is_variant(hd.TAG):
                    raise MdocError("ATTRIBUTE_DECODE_FAILURE")
                tv = tattr.tagged_value()
                if not tv.is_variant(hd.BYTES):
                    raise MdocError("ATTRIBUTE_DECODE_FAILURE")
                sub = hd.decode(resp[tv.str_pos : tv.str_pos + tv.str_len],
                                0, offset=tv.str_pos)
                if sub is None:
                    raise MdocError("ATTRIBUTE_DECODE_FAILURE")
                er = sub[0]
                ei = need(er.lookup(resp, b"elementIdentifier"),
                          "ATTRIBUTE_EI_MISSING")
                ev = need(er.lookup(resp, b"elementValue"),
                          "ATTRIBUTE_EV_MISSING")
                digid = need(er.lookup(resp, b"digestID"),
                             "ATTRIBUTE_DID_MISSING")
                rnd = need(er.lookup(resp, b"random"),
                           "ATTRIBUTE_RANDOM_MISSING")
                if ev[1].t in (hd.ARRAY, hd.MAP):
                    continue
                self.attributes.append(FullAttribute(
                    id_ind=ei[1].position(),
                    id_len=ei[1].length(),
                    val_ind=ev[0].position(),
                    val_len=ev[1].length(),
                    dig_ind=digid[0].position(),
                    dig_len=digid[0].length() + digid[1].length() + 1,
                    rand_ind=rnd[0].position(),
                    rand_len=(rnd[0].length() + rnd[1].length() + 1
                              + (1 if rnd[1].length() < 24 else 2)),
                    namespace=sn,
                    digest_id=digid[1].as_unsigned(),
                    tag_ind=tattr.header_pos,
                    tag_len=tv.str_len + 4,  # +4 for D8 18 58 <len>
                ))

        ds = need(docs0.lookup(resp, b"deviceSigned"),
                  "DEVICE_SIGNED_MISSING")[1]
        da = need(ds.lookup(resp, b"deviceAuth"), "DEVICE_AUTH_MISSING")[1]
        dsi = need(da.lookup(resp, b"deviceSignature"),
                   "DEVICE_SIGNATURE_MISSING")[1]
        self._copy_header(self.dksig, dsi.index(3))

        # Parse tagged MSO: skip 5 bytes (D8 18 59 <len2>)
        if not tmso.is_variant(hd.BYTES):
            raise MdocError("MSO_MISSING")
        pmso_start = tmso.str_pos + 5
        pmso = resp[pmso_start : tmso.str_pos + tmso.str_len]
        out = hd.decode(pmso, 0)
        if out is None:
            raise MdocError("MSO_DECODING_FAILURE")
        mso = out[0]

        nv = need(mso.lookup(pmso, C.K_VALIDITY_INFO),
                  "VALIDITY_INFO_MISSING")
        nvf = need(nv[1].lookup(pmso, C.K_VALID_FROM),
                   "VALIDITY_INFO_MISSING")
        _copy_kv(self.valid_from, *nvf)
        nvu = need(nv[1].lookup(pmso, C.K_VALID_UNTIL),
                   "VALIDITY_INFO_MISSING")
        _copy_kv(self.valid_until, *nvu)
        ndki = need(mso.lookup(pmso, C.K_DEVICE_KEY_INFO),
                    "DEVICE_KEY_INFO_MISSING")
        _copy_kv(self.dev_key_info, *ndki)
        ndk = need(ndki[1].lookup(pmso, C.K_DEVICE_KEY),
                   "DEVICE_KEY_MISSING")
        npkx = need(ndk[1].lookup_negative(1), "DEVICE_KEY_MISSING")
        _copy_kv(self.dev_key_pkx, *npkx)
        npky = need(ndk[1].lookup_negative(2), "DEVICE_KEY_MISSING")
        _copy_kv(self.dev_key_pky, *npky)
        nvd = need(mso.lookup(pmso, C.K_VALUE_DIGESTS),
                   "MSO_DECODING_FAILURE")
        _copy_kv(self.value_digests, *nvd)

        for attr in self.attributes:
            nss = need(nvd[1].lookup(pmso, attr.namespace),
                       "MSO_DECODING_FAILURE")
            hattr = need(nss[1].lookup_unsigned(attr.digest_id),
                         "MSO_DECODING_FAILURE")
            _copy_kv(attr.mso, *hattr)

        self.tagged_mso_bytes = (
            C.K_COSE1_PREFIX
            + bytes([(self.t_mso.len >> 8) & 0xFF, self.t_mso.len & 0xFF])
            + resp[self.t_mso.pos : self.t_mso.pos + self.t_mso.len])

    @staticmethod
    def _copy_header(ind: CborIndex, n: hd.CborDoc) -> None:
        ind.k = n.header_pos
        if n.t in (hd.TEXT, hd.BYTES):
            ind.pos = n.str_pos
            ind.len = n.str_len


# ---------------------------------------------------------------------------
# transcript hash (mdoc_witness.h:436-495)
# ---------------------------------------------------------------------------

def _append_bytes_len(buf: bytearray, n: int) -> None:
    assert n < 65536
    if n < 24:
        buf.append(0x40 + n)
    elif n < 256:
        buf += bytes([0x58, n & 0xFF])
    else:
        buf += bytes([0x59, (n >> 8) & 0xFF, n & 0xFF])


def _append_text_len(buf: bytearray, n: int) -> None:
    assert n < 256
    if n < 24:
        buf.append(0x60 + n)
    else:
        buf += bytes([0x78, n])


def compute_transcript_hash(transcript: bytes,
                            doc_type: Optional[bytes] = None) -> int:
    """SHA-256 of the COSE1 DeviceAuthenticationBytes, as a big-endian
    natural (mdoc_witness.h:455-495)."""
    da = bytearray(b"\x84\x74DeviceAuthentication")
    da += transcript
    if doc_type is not None and len(doc_type) < 256:
        dt = bytearray()
        _append_text_len(dt, len(doc_type))
        dt += doc_type
    else:
        dt = bytearray(b"\x75org.iso.18013.5.1.mDL")
    da += dt
    da += b"\xD8\x18\x41\xA0"

    cose1 = bytearray(
        b"\x84\x6aSignature1\x43\xa1\x01\x26\x40")
    l1 = len(da)
    l2 = l1 + (4 if l1 < 256 else 5)
    _append_bytes_len(cose1, l2)
    cose1 += b"\xD8\x18"
    _append_bytes_len(cose1, l1)
    cose1 += da
    return int.from_bytes(hashlib.sha256(bytes(cose1)).digest(), "big")


# ---------------------------------------------------------------------------
# SHA message witness matching FlatSHA256Witness::transform_and_witness_message
# ---------------------------------------------------------------------------

def transform_and_witness_message(msg: bytes, max_blocks: int
                                  ) -> Tuple[int, bytes, List[ShaBlockWitness]]:
    """Returns (nb, padded-to-max bytes, block witnesses [max_blocks])."""
    padded = sha256_pad(msg)
    nb = len(padded) // 64
    if nb > max_blocks:
        raise MdocError("TAGGED_MSO_TOO_BIG")
    # Dummy blocks past nb keep chaining through h1 over zero data
    # (flatsha256_witness.cc:155-164) — the circuit asserts the transform
    # for every block.
    padded_full = padded + b"\x00" * (64 * (max_blocks - nb))
    H = list(SHA256_INIT)
    bws = []
    for b in range(max_blocks):
        bw = transform_block_witness(H, padded_full[64 * b : 64 * (b + 1)])
        bws.append(bw)
        H = bw.h1
    return nb, padded_full, bws


# ---------------------------------------------------------------------------
# witness containers (fill orders mirror mdoc_witness.h fill_witness)
# ---------------------------------------------------------------------------

def _int_bits(v: int, n: int, F) -> List[int]:
    return [F.of_scalar((v >> i) & 1) for i in range(n)]


def _bytes_bits(data: bytes, F) -> List[int]:
    out = []
    for b in data:
        out.extend(_int_bits(b, 8, F))
    return out


class MdocHashWitness:
    """(mdoc_witness.h:591-917); F is GF2_128."""

    def __init__(self, num_attr: int, F, version: int = 7):
        self.num_attr = num_attr
        self.F = F
        self.version = version

    def compute_witness(self, mdoc: bytes, transcript: bytes,
                        attrs: List[RequestedAttribute]) -> None:
        self.pm = ParsedMdoc()
        self.pm.parse_device_response(mdoc)
        if self.version < 4:
            raise MdocError("VERSION_NOT_SUPPORTED")
        maxb = C.max_sha_blocks(self.version)
        if self.pm.t_mso.len >= maxb * 64 - 9 - C.K_COSE1_PREFIX_LEN:
            raise MdocError("TAGGED_MSO_TOO_BIG")

        self.numb, self.signed_bytes, self.bw = \
            transform_and_witness_message(self.pm.tagged_mso_bytes, maxb)

        h1 = self.bw[self.numb - 1].h1
        self.e_nat = int.from_bytes(
            b"".join(x.to_bytes(4, "big") for x in h1), "big")
        pmso = self.pm.t_mso.pos + 5
        self.dpkx_nat = int.from_bytes(
            mdoc[pmso + self.pm.dev_key_pkx.pos :
                 pmso + self.pm.dev_key_pkx.pos + 32], "big")
        self.dpky_nat = int.from_bytes(
            mdoc[pmso + self.pm.dev_key_pky.pos :
                 pmso + self.pm.dev_key_pky.pos + 32], "big")

        self.attr_bytes: List[bytes] = []
        self.atw: List[List[ShaBlockWitness]] = []
        self.attr_n: List[int] = []
        self.attr_mso: List[CborIndex] = []
        self.attr_ei: List[Tuple[int, int]] = []
        self.attr_ev: List[Tuple[int, int]] = []
        self.attr_sh: List[dict] = []

        for attr in attrs:
            fa = None
            for cand in self.pm.attributes:
                if (cand.id_len == len(attr.id) and cand.id_len <= 32 and
                        mdoc[cand.id_ind : cand.id_ind + cand.id_len]
                        == attr.id):
                    fa = cand
                    break
            if fa is None:
                raise MdocError("ATTRIBUTE_NOT_FOUND")
            n, padded, bws = transform_and_witness_message(
                mdoc[fa.tag_ind : fa.tag_ind + fa.tag_len], 2)
            self.attr_n.append(n)
            self.attr_bytes.append(padded)
            self.atw.append(bws)
            self.attr_mso.append(fa.mso)

            if self.version >= 7:
                ei_off = fa.id_ind - fa.tag_ind
                ei_off -= 1 if fa.id_len < 24 else 2
                ei_off -= 17 + 1
                ei_len = 17 + 1 + fa.id_len + (1 if fa.id_len < 24 else 2)
                ev_off = fa.val_ind - fa.tag_ind - 1
                ev_len = len(attr.cbor_value) + 12 + 1
                self.attr_ei.append((ei_off, ei_len))
                self.attr_ev.append((ev_off, ev_len))

                triples = [
                    (fa.dig_ind - fa.tag_ind - 1, fa.dig_len, 0),
                    (fa.rand_ind - fa.tag_ind - 1, fa.rand_len, 1),
                    (ei_off, ei_len, 2),
                    (ev_off, ev_len, 3),
                ]
                by_i = sorted(triples, key=lambda t: t[0])
                sh = dict(
                    i1=by_i[1][0], i2=by_i[2][0], i3=by_i[3][0],
                    l=[by_i[0][1], by_i[1][1], by_i[2][1], by_i[3][1]])
                # perm: for each original slot, its rank in sorted order
                perm = 0
                ranked = [(t[2], ord_) for ord_, t in enumerate(by_i)]
                for orig, ord_ in sorted(ranked):
                    perm |= ord_ << (2 * orig)
                sh["perm"] = perm
                self.attr_sh.append(sh)
            else:
                witness_len = fa.id_len + fa.val_len + 1 + 12
                self.attr_ei.append((
                    fa.id_ind - fa.tag_ind - 1 - (1 if fa.id_len > 23 else 0),
                    witness_len))
                self.attr_ev.append((fa.val_ind - fa.tag_ind, fa.val_len))
                self.attr_sh.append(None)

    # -- fill (mdoc_witness.h:743-783) ---------------------------------

    def fill_witness(self) -> List[int]:
        F = self.F
        enc = BitPluckerEncoder(F, C.K_SHA_PLUCKER_BITS)
        maxb = C.max_sha_blocks(self.version)
        out: List[int] = []
        out.extend(_int_bits(self.numb, 8, F))
        for i in range(C.K_COSE1_PREFIX_LEN, maxb * 64):
            out.extend(_int_bits(self.signed_bytes[i], 8, F))
        for j in range(maxb):
            out.extend(self._fill_sha(enc, self.bw[j]))
        out.extend(_int_bits(self.pm.valid_from.k, C.K_CBOR_INDEX_BITS, F))
        out.extend(_int_bits(self.pm.valid_until.k, C.K_CBOR_INDEX_BITS, F))
        out.extend(_int_bits(self.pm.dev_key_info.k, C.K_CBOR_INDEX_BITS, F))
        out.extend(_int_bits(self.pm.value_digests.k, C.K_CBOR_INDEX_BITS, F))
        for ai in range(self.num_attr):
            for i in range(2 * 64):
                out.extend(_int_bits(self.attr_bytes[ai][i], 8, F))
            for j in range(2):
                out.extend(self._fill_sha(enc, self.atw[ai][j]))
            out.extend(_int_bits(self.attr_mso[ai].v, C.K_CBOR_INDEX_BITS, F))
            out.extend(_int_bits(self.attr_ei[ai][0], C.K_CBOR_INDEX_BITS, F))
            out.extend(_int_bits(self.attr_ei[ai][1], C.K_CBOR_INDEX_BITS, F))
            out.extend(_int_bits(self.attr_ev[ai][0], C.K_CBOR_INDEX_BITS, F))
            out.extend(_int_bits(self.attr_ev[ai][1], C.K_CBOR_INDEX_BITS, F))
            if self.version >= 7:
                sh = self.attr_sh[ai]
                out.extend(_int_bits(sh["i1"], C.K_CBOR_INDEX_BITS, F))
                out.extend(_int_bits(sh["i2"], C.K_CBOR_INDEX_BITS, F))
                out.extend(_int_bits(sh["i3"], C.K_CBOR_INDEX_BITS, F))
                for j in range(4):
                    out.extend(_int_bits(sh["l"][j], C.K_CBOR_INDEX_BITS, F))
                out.extend(_int_bits(sh["perm"], 8, F))
        return out

    def _fill_sha(self, enc, bw: ShaBlockWitness) -> List[int]:
        out = []
        for v in bw.outw:
            out.extend(enc.mkpacked_v32(v))
        for k in range(64):
            out.extend(enc.mkpacked_v32(bw.oute[k]))
            out.extend(enc.mkpacked_v32(bw.outa[k]))
        for v in bw.h1:
            out.extend(enc.mkpacked_v32(v))
        return out


class MdocSignatureWitness:
    """(mdoc_witness.h:591-647); over the P-256 base field."""

    def __init__(self, ec, Fb):
        self.ec = ec
        self.Fb = Fb  # p256 base field (host ops)

    def compute_witness(self, pkx: int, pky: int, mdoc: bytes,
                        transcript: bytes) -> None:
        pm = ParsedMdoc()
        pm.parse_device_response(mdoc)
        self.pm = pm
        self.e_nat = int.from_bytes(
            hashlib.sha256(pm.tagged_mso_bytes).digest(), "big")

        ln = pm.sig.len
        r = int.from_bytes(mdoc[pm.sig.pos : pm.sig.pos + ln // 2], "big")
        s = int.from_bytes(mdoc[pm.sig.pos + ln // 2 : pm.sig.pos + ln],
                           "big")
        self.ew = ecdsa_witness(self.ec, pkx, pky, self.e_nat, r, s)

        self.e2_nat = compute_transcript_hash(transcript, pm.doc_type)
        l2 = pm.dksig.len
        r2 = int.from_bytes(mdoc[pm.dksig.pos : pm.dksig.pos + l2 // 2],
                            "big")
        s2 = int.from_bytes(mdoc[pm.dksig.pos + l2 // 2 : pm.dksig.pos + l2],
                            "big")
        pmso = pm.t_mso.pos + 5
        self.dpkx = int.from_bytes(
            mdoc[pmso + pm.dev_key_pkx.pos : pmso + pm.dev_key_pkx.pos + 32],
            "big")
        self.dpky = int.from_bytes(
            mdoc[pmso + pm.dev_key_pky.pos : pmso + pm.dev_key_pky.pos + 32],
            "big")
        self.dkw = ecdsa_witness(self.ec, self.dpkx, self.dpky, self.e2_nat,
                                 r2, s2)

    def fill_witness(self, ap: List[int]) -> List[int]:
        """ap: the 6 committed MAC keys (2 per value)."""
        F = self.Fb
        out = [self.e_nat % F.p, self.dpkx % F.p, self.dpky % F.p]
        out.extend(self.ew.fill())
        out.extend(self.dkw.fill())
        for i, val in enumerate([self.e_nat, self.dpkx, self.dpky]):
            out.extend(mac_witness_values(
                F, C.K_MAC_PLUCKER_BITS, ap[2 * i : 2 * i + 2], val % F.p))
        return out
