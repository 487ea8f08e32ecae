"""Length-prefixed SoundKit v2 frame stream.

Behavioral equivalent of ``soundkit/src/frame_stream.rs``: header-size
probe, payload-size bound (1 MiB default), CRC32 verification, and
ChaCha20-Poly1305 nonce-prefixed decryption when FLAG_ENCRYPTED
(:66-136); 4 MiB max buffer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from soundkit_tpu_torch.core.crypto import ChaCha20Poly1305PacketCipher, CryptoError
from soundkit_tpu_torch.core.frame_header import FrameHeaderError, FrameHeaderV2

DEFAULT_MAX_BUFFERED_BYTES = 4 * 1024 * 1024
DEFAULT_MAX_PAYLOAD_BYTES = 1024 * 1024


class FrameStreamError(ValueError):
    pass


@dataclass
class SoundKitFrame:
    header: FrameHeaderV2
    payload: bytes
    encrypted: bool
    encoded_header_bytes: bytes
    encrypted_payload_size: int


@dataclass
class SoundKitFrameStreamOptions:
    max_buffered_bytes: int = DEFAULT_MAX_BUFFERED_BYTES
    max_payload_bytes: int = DEFAULT_MAX_PAYLOAD_BYTES
    verify_packet_crc32: bool = True
    cipher: Optional[ChaCha20Poly1305PacketCipher] = None


class SoundKitFrameStream:
    def __init__(self, options: Optional[SoundKitFrameStreamOptions] = None):
        self.options = options or SoundKitFrameStreamOptions()
        self._buffer = bytearray()

    def set_cipher(self, cipher: Optional[ChaCha20Poly1305PacketCipher]) -> None:
        self.options.cipher = cipher

    def reset(self) -> None:
        self._buffer.clear()

    @property
    def buffered_bytes(self) -> int:
        return len(self._buffer)

    def push(self, chunk: bytes) -> List[SoundKitFrame]:
        if chunk:
            self._buffer.extend(chunk)
        if len(self._buffer) > self.options.max_buffered_bytes:
            raise FrameStreamError(
                f"SoundKit frame buffer exceeded {self.options.max_buffered_bytes} bytes"
            )

        frames: List[SoundKitFrame] = []
        while True:
            if len(self._buffer) < FrameHeaderV2.BASE_SIZE:
                break
            try:
                header_size = FrameHeaderV2.header_size(self._buffer)
            except FrameHeaderError as e:
                raise FrameStreamError(f"decode SoundKit v2 header failed: {e}")
            if len(self._buffer) < header_size:
                break
            encoded_header = bytes(self._buffer[:header_size])
            try:
                header = FrameHeaderV2.decode(encoded_header)
            except FrameHeaderError as e:
                raise FrameStreamError(f"decode SoundKit v2 header failed: {e}")
            payload_size = header.payload_size
            if payload_size > self.options.max_payload_bytes:
                raise FrameStreamError(
                    f"SoundKit frame payload exceeded {self.options.max_payload_bytes} bytes"
                )
            frame_size = header_size + payload_size
            if len(self._buffer) < frame_size:
                break
            payload = bytes(self._buffer[header_size:frame_size])
            if (
                self.options.verify_packet_crc32
                and header.packet_crc32 is not None
                and not header.verify_packet_crc32(payload)
            ):
                raise FrameStreamError("SoundKit frame CRC32 mismatch")

            encrypted = header.is_encrypted
            encrypted_size = payload_size
            if encrypted:
                if self.options.cipher is None:
                    raise FrameStreamError(
                        "SoundKit frame is encrypted but no cipher is configured"
                    )
                try:
                    payload = self.options.cipher.decrypt_nonce_prefixed(payload, b"")
                except CryptoError as e:
                    raise FrameStreamError(str(e))

            frames.append(
                SoundKitFrame(
                    header=header,
                    payload=payload,
                    encrypted=encrypted,
                    encoded_header_bytes=encoded_header,
                    encrypted_payload_size=encrypted_size,
                )
            )
            del self._buffer[:frame_size]
        return frames

    def finish(self) -> None:
        if self._buffer:
            raise FrameStreamError(
                f"SoundKit frame stream ended with {len(self._buffer)} buffered bytes"
            )


def encode_frame(
    header: FrameHeaderV2,
    payload: bytes,
) -> bytes:
    """Serialize one frame (header must already carry payload_size/crc)."""
    return header.encode() + payload
