"""ChaCha20-Poly1305 packet crypto.

Behavioral equivalent of ``soundkit/src/crypto.rs``: nonce-prefixed
seal/open with AAD (:80-162) and the decimal-string key parser
(:165-189, big-integer base-10 into 32 big-endian bytes).

Port: the ``cryptography`` package is imported where a cipher is made or
used, not when the module loads, so the error types, the constants and
``key_from_decimal`` (and the modules above them: the frame stream, the
simple API) import without it; a cipher made without it raises an
``ImportError`` that names the package. The rest is the JAX package's
code.
"""
from __future__ import annotations

KEY_BYTES = 32
NONCE_BYTES = 12
TAG_BYTES = 16
PACKET_OVERHEAD_BYTES = NONCE_BYTES + TAG_BYTES


class CryptoError(ValueError):
    pass


class InvalidKeyLength(CryptoError):
    pass


class InvalidNonceLength(CryptoError):
    pass


class InvalidDecimalKey(CryptoError):
    pass


class DecimalKeyOverflow(CryptoError):
    pass


class PacketTooShort(CryptoError):
    pass


class DecryptFailed(CryptoError):
    pass


def _aead_class():
    try:
        from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    except ImportError as e:
        raise ImportError("ChaCha20-Poly1305 needs the 'cryptography' package, which is not "
                          f"installed ({e})") from e
    return ChaCha20Poly1305


class ChaCha20Poly1305PacketCipher:
    def __init__(self, key: bytes):
        if len(key) != KEY_BYTES:
            raise InvalidKeyLength(f"invalid key length {len(key)}; expected {KEY_BYTES} bytes")
        self._aead = _aead_class()(bytes(key))

    @classmethod
    def new_from_decimal_key(cls, encoded: str) -> "ChaCha20Poly1305PacketCipher":
        return cls(key_from_decimal(encoded))

    def encrypt_nonce_prefixed(self, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
        if len(nonce) != NONCE_BYTES:
            raise InvalidNonceLength(
                f"invalid nonce length {len(nonce)}; expected {NONCE_BYTES} bytes"
            )
        ct = self._aead.encrypt(bytes(nonce), bytes(plaintext), bytes(aad))
        return bytes(nonce) + ct

    def decrypt_nonce_prefixed(self, packet: bytes, aad: bytes = b"") -> bytes:
        if len(packet) < PACKET_OVERHEAD_BYTES:
            raise PacketTooShort(
                f"encrypted packet too short {len(packet)}; expected at least "
                f"{PACKET_OVERHEAD_BYTES} bytes"
            )
        from cryptography.exceptions import InvalidTag

        nonce, ct = packet[:NONCE_BYTES], packet[NONCE_BYTES:]
        try:
            return self._aead.decrypt(bytes(nonce), bytes(ct), bytes(aad))
        except InvalidTag:
            raise DecryptFailed("ChaCha20-Poly1305 decryption failed")


def key_from_decimal(encoded: str) -> bytes:
    """Base-10 big integer -> 32 big-endian bytes (crypto.rs:165-189)."""
    encoded = encoded.strip()
    if not encoded or not encoded.isdigit():
        raise InvalidDecimalKey("invalid decimal key string")
    value = int(encoded)
    if value >= 1 << (8 * KEY_BYTES):
        raise DecimalKeyOverflow("decimal key does not fit in 32 bytes")
    return value.to_bytes(KEY_BYTES, "big")
