"""Audio content envelope crypto (ACE1).

Behavioral equivalent of ``soundkit/src/audio_content_crypto.rs``:
``ACE1`` envelope (4-byte magic + u32-LE key epoch + nonce-prefixed
AEAD, :7-11,167-231), canonical ``AudioGroupMetadata`` AAD
serialization (magic ``AEG1``, :36-71), AAD domain separation
(``infidelity.audio-content.v1\\0`` + epoch, :242-248), 16 MiB
plaintext cap, zero-key / zero-epoch rejection.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

from soundkit_tpu_torch.core.crypto import (
    ChaCha20Poly1305PacketCipher,
    CryptoError,
    KEY_BYTES,
    PACKET_OVERHEAD_BYTES,
)

ENVELOPE_MAGIC = b"ACE1"
ENVELOPE_HEADER_BYTES = 8
ENVELOPE_OVERHEAD_BYTES = ENVELOPE_HEADER_BYTES + PACKET_OVERHEAD_BYTES
MAX_PLAINTEXT_BYTES = 16 * 1024 * 1024
MAX_SESSION_CONTEXT_BYTES = 128

_AAD_DOMAIN = b"infidelity.audio-content.v1\x00"
_GROUP_AAD_MAGIC = b"AEG1"


class AudioContentCryptoError(ValueError):
    pass


class ZeroKey(AudioContentCryptoError):
    pass


class InvalidKeyEpoch(AudioContentCryptoError):
    pass


class KeyEpochMismatch(AudioContentCryptoError):
    def __init__(self, expected: int, actual: int):
        super().__init__(
            f"audio content key epoch {actual} does not match expected epoch {expected}"
        )
        self.expected = expected
        self.actual = actual


@dataclass(frozen=True)
class AudioGroupMetadata:
    session_context: bytes
    transport_session_id: int
    config_generation: int
    epoch_id: int
    pts_samples: int
    sample_rate: int
    frame_count: int
    group_count: int
    group_id: int
    group_index: int
    channel_start: int
    channel_count: int
    payload_kind: int
    sample_format: int
    flags: int

    def associated_data(self) -> bytes:
        ctx = bytes(self.session_context)
        if not ctx or len(ctx) > MAX_SESSION_CONTEXT_BYTES:
            raise AudioContentCryptoError(
                f"audio session context is {len(ctx)} bytes; expected 1 to "
                f"{MAX_SESSION_CONTEXT_BYTES} bytes"
            )
        out = bytearray()
        out += _GROUP_AAD_MAGIC
        out.append(len(ctx))
        out += ctx
        out += struct.pack("<Q", self.transport_session_id)
        out += struct.pack("<I", self.config_generation)
        out += struct.pack("<Q", self.epoch_id)
        out += struct.pack("<Q", self.pts_samples)
        out += struct.pack("<I", self.sample_rate)
        out += struct.pack("<I", self.frame_count)
        out += struct.pack("<H", self.group_count)
        out += struct.pack("<H", self.group_id)
        out += struct.pack("<H", self.group_index)
        out += struct.pack("<H", self.channel_start)
        out += struct.pack("<H", self.channel_count)
        out.append(self.payload_kind & 0xFF)
        out.append(self.sample_format & 0xFF)
        out.append(self.flags & 0xFF)
        return bytes(out)


def _authenticated_data(key_epoch: int, aad: bytes) -> bytes:
    return _AAD_DOMAIN + struct.pack("<I", key_epoch) + bytes(aad)


def _validate_epoch(key_epoch: int) -> None:
    if key_epoch == 0:
        raise InvalidKeyEpoch("the content key epoch must be positive")


class AudioContentCipher:
    def __init__(self, key: bytes):
        if len(key) != KEY_BYTES:
            raise AudioContentCryptoError(
                f"invalid content key length {len(key)}; expected {KEY_BYTES} bytes"
            )
        if all(b == 0 for b in key):
            raise ZeroKey("the content key must not be all zero")
        self._cipher = ChaCha20Poly1305PacketCipher(key)

    def seal(self, key_epoch: int, nonce: bytes, plaintext: bytes, aad: bytes) -> bytes:
        _validate_epoch(key_epoch)
        if len(plaintext) > MAX_PLAINTEXT_BYTES:
            raise AudioContentCryptoError(
                f"audio content is {len(plaintext)} bytes; the maximum is "
                f"{MAX_PLAINTEXT_BYTES} bytes"
            )
        enc = self._cipher.encrypt_nonce_prefixed(
            nonce, plaintext, _authenticated_data(key_epoch, aad)
        )
        return ENVELOPE_MAGIC + struct.pack("<I", key_epoch) + enc

    def open(self, expected_key_epoch: int, envelope: bytes, aad: bytes) -> bytes:
        _validate_epoch(expected_key_epoch)
        if len(envelope) < ENVELOPE_OVERHEAD_BYTES:
            raise AudioContentCryptoError(
                f"audio content envelope is {len(envelope)} bytes; the minimum is "
                f"{ENVELOPE_OVERHEAD_BYTES} bytes"
            )
        maximum = MAX_PLAINTEXT_BYTES + ENVELOPE_OVERHEAD_BYTES
        if len(envelope) > maximum:
            raise AudioContentCryptoError(
                f"audio content envelope is {len(envelope)} bytes; the maximum is "
                f"{maximum} bytes"
            )
        if envelope[:4] != ENVELOPE_MAGIC:
            raise AudioContentCryptoError("invalid audio content envelope")
        actual = struct.unpack_from("<I", envelope, 4)[0]
        if actual != expected_key_epoch:
            raise KeyEpochMismatch(expected_key_epoch, actual)
        try:
            return self._cipher.decrypt_nonce_prefixed(
                envelope[ENVELOPE_HEADER_BYTES:], _authenticated_data(actual, aad)
            )
        except CryptoError as e:
            # wrap like the reference's Cipher(CryptoError) variant
            raise AudioContentCryptoError(str(e))
