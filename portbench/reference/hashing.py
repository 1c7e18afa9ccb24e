"""Host-side hashing primitives: generator chains, hash-to-group, nonces.

These are one-time-setup or per-proof-scalar operations; they run on host
with hashlib (bit-exact with the reference's `sha3` / `blake2` crates) and
feed the device kernels with byte-exact inputs.

Parity targets:
  - GeneratorsChain: SHAKE256("GeneratorsChain" ‖ label) XOF, 64-byte blocks
    → hash-to-group (reference src/generators/generators_chain.rs:23-49)
  - hash_from_bytes_sha3_512 (reference src/protocols/curve_point_protocol.rs:31-35)
  - nonce: Blake2bMac512 keyed, persona=label (reference src/utils/generic.rs:30-61)
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

from .errors import InvalidLength
from . import ristretto as hr

# Blake2b persona field limit (blake2 spec §2.8), as enforced by the reference.
BLAKE2B_PERSONA_LIMIT = 16


def generators_chain(label: bytes, count: int) -> List[hr.Point]:
    """First `count` points of the deterministic generator chain for `label`."""
    xof = hashlib.shake_256(b"GeneratorsChain" + label)
    stream = xof.digest(64 * count)
    return [hr.from_uniform_bytes(stream[i * 64 : (i + 1) * 64]) for i in range(count)]


def party_label(prefix: int, party_index: int) -> bytes:
    """Per-party chain label: [b'G'|b'H', LE32(party_index)]
    (reference src/generators/bulletproof_gens.rs:92-97)."""
    return bytes([prefix]) + party_index.to_bytes(4, "little")


def hash_from_bytes_sha3_512(data: bytes) -> hr.Point:
    return hr.from_uniform_bytes(hashlib.sha3_512(data).digest())


def _encode_u32(value: int) -> bytes:
    if value < 0 or value > 0xFFFFFFFF:
        raise InvalidLength("Bad size encoding")
    return value.to_bytes(4, "little")


def nonce(seed_nonce: int, label: str, index_j: Optional[int] = None, index_k: Optional[int] = None) -> int:
    """Deterministic scalar nonce (mask-recoverable proofs).

    nonce = Blake2b-512(key = 0x00 ‖ seed ‖ ("j"‖LE32(j))? ‖ ("k"‖LE32(k))?,
                        person = label, data = b"") reduced wide mod l.
    """
    encoded_label = label.encode()
    if len(encoded_label) > BLAKE2B_PERSONA_LIMIT:
        raise InvalidLength("Bad nonce label encoding")
    key = bytearray()
    key.append(0)
    key += hr.scalar_to_bytes(seed_nonce)
    if index_j is not None:
        key += b"j" + _encode_u32(index_j)
    if index_k is not None:
        key += b"k" + _encode_u32(index_k)
    h = hashlib.blake2b(key=bytes(key), person=encoded_label, digest_size=64)
    return hr.scalar_from_bytes_mod_order_wide(h.digest())
