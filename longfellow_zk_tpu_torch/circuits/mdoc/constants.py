"""mdoc circuit constants (twin of reference
lib/circuits/mdoc/mdoc_constants.h and the in-circuit check strings in
mdoc_hash.h — interop wire-format/CBOR-prefix data)."""

K_MAX_SHA_BLOCKS = 40
K_CBOR_INDEX_BITS = 12
K_SHA_PLUCKER_BITS = 4
K_MAC_PLUCKER_BITS = 2

# COSE1 prefix of the signed MSO bytes (mdoc_constants.h:32-36):
# 84 6A "Signature1" 43 A1 01 26 40 59 (then 2-byte length)
K_COSE1_PREFIX = bytes([
    0x84, 0x6A, 0x53, 0x69, 0x67, 0x6E, 0x61, 0x74, 0x75,
    0x72, 0x65, 0x31, 0x43, 0xA1, 0x01, 0x26, 0x40, 0x59,
])
K_COSE1_PREFIX_LEN = 18


def max_sha_blocks(version: int) -> int:
    """mdoc_witness.h max_shablocks: v<=6 uses 35 blocks, v7+ 40."""
    return 35 if version <= 6 else K_MAX_SHA_BLOCKS


def max_mso_len(version: int = 7) -> int:
    return max_sha_blocks(version) * 64 - 9 - K_COSE1_PREFIX_LEN


# host-side CBOR key names (mdoc_constants.h:56-82)
K_VALIDITY_INFO = b"validityInfo"
K_VALID_FROM = b"validFrom"
K_VALID_UNTIL = b"validUntil"
K_DEVICE_KEY_INFO = b"deviceKeyInfo"
K_DEVICE_KEY = b"deviceKey"
K_VALUE_DIGESTS = b"valueDigests"
K_ORG = b"org.iso.18013.5.1"
K_DIGEST_ID = bytes([0x68]) + b"digestID"
K_RANDOM_ID = bytes([0x66]) + b"random"

K_SUPPORTED_NAMESPACES = [b"org.iso.18013.5.1", b"org.iso.23220.1"]

# in-circuit prefix-check strings (mdoc_hash.h:515-545; include headers)
K_VALID_FROM_CHECK = bytes([0x69]) + b"validFrom" + bytes([0xC0, 0x74])
K_VALID_UNTIL_CHECK = bytes([0x6A]) + b"validUntil" + bytes([0xC0, 0x74])
K_DEVICE_KEY_INFO_CHECK = (
    bytes([0x6D]) + b"deviceKeyInfo" + bytes([0xA1, 0x69]) + b"deviceKey"
    + bytes([0xA4, 0x01, 0x02, 0x20, 0x01, 0x21, 0x58, 0x20]))
K_PKX_IND = len(K_DEVICE_KEY_INFO_CHECK)  # 33
K_PKY_IND = 68  # 64 + 3-byte tag + 1
K_VALUE_DIGESTS_CHECK = bytes([0x6C]) + b"valueDigests"
K_TAG32 = bytes([0x58, 0x20])
K_DATE_LEN = 20

K_MDL_DOCTYPE = b"org.iso.18013.5.1.mDL"
