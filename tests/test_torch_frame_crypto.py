"""Port parity of the SoundKit frame format and its crypto: the v1 and v2
frame headers (``core/frame_header.py``), the length-prefixed v2 frame
stream (``core/frame_stream.py``), the ChaCha20-Poly1305 packet cipher and
the decimal key parser (``core/crypto.py``), the ACE1 content envelope and
its group metadata (``core/audio_content_crypto.py``) and the v1 audio
packets (``core/audio_packet.py``), each against the JAX package's on the
same inputs: equal bytes (headers, frames, ciphertexts, envelopes,
packets), equal parses and equal samples, and the same error types and
messages. Nonces are fixed, so every ciphertext is reproducible."""
import dataclasses
import struct

import numpy as np
import pytest

from soundkit_tpu.codecs import encoders as jax_encoders
from soundkit_tpu.codecs import opus_core as jax_opus_core
from soundkit_tpu.core import audio_content_crypto as jax_ace
from soundkit_tpu.core import audio_packet as jax_packet
from soundkit_tpu.core import audio_types as jax_types
from soundkit_tpu.core import crypto as jax_crypto
from soundkit_tpu.core import frame_header as jax_fh
from soundkit_tpu.core import frame_stream as jax_fs
from soundkit_tpu_torch.codecs import encoders, opus_core
from soundkit_tpu_torch.core import audio_content_crypto as ace
from soundkit_tpu_torch.core import audio_packet, audio_types, crypto
from soundkit_tpu_torch.core import frame_header as fh
from soundkit_tpu_torch.core import frame_stream as fs

from torch_port_helpers import OpusPacketEncoder

KEY_DECIMAL = "83843157117408337365446905028299378179116700186920144823595584430653437972238"
KEY = bytes(range(0x80, 0xA0))


def _both(name: str):
    """The enum member ``name`` of EncodingFlag in (port, JAX package)."""
    return audio_types.EncodingFlag[name], jax_types.EncodingFlag[name]


def _endian(big: bool):
    e = "BIG" if big else "LITTLE"
    return audio_types.Endianness[e], jax_types.Endianness[e]


def _fields(h) -> tuple:
    """A header's fields, enums by name and value."""
    return tuple((f.name, getattr(h, f.name).name) if hasattr(getattr(h, f.name), "name")
                 else getattr(h, f.name) for f in dataclasses.fields(h))


# ---------------------------------------------------------------------------
# v1 and v2 headers
# ---------------------------------------------------------------------------

V1_CASES = [("OPUS", 960, 48000, 2, 16, False, 42), ("FLAC", 4096, 44100, 1, 24, False, None),
            ("PCM_SIGNED", 65535, 8000, 6, 32, True, 2**64 - 1),
            ("PCM_FLOAT", 0, 192000, 2, 32, True, None), ("AAC", 1024, 22050, 2, 16, False, 0)]


@pytest.mark.parametrize("case", V1_CASES)
def test_v1_header_encodes_and_decodes_like_the_jax_package(case):
    enc, size, rate, ch, bits, big, fid = case
    (pe, je), (pn, jn) = _both(enc), _endian(big)
    port = fh.FrameHeader(pe, size, rate, ch, bits, pn, id=fid)
    ref = jax_fh.FrameHeader(je, size, rate, ch, bits, jn, id=fid)
    data = port.encode()
    assert data == ref.encode() and port.size() == ref.size() == len(data)
    assert _fields(fh.FrameHeader.decode(data)) == _fields(jax_fh.FrameHeader.decode(data))
    assert fh.FrameHeader.decode(data) == port
    assert fh.get_encoding_flag(data).name == jax_fh.get_encoding_flag(data).name == enc


@pytest.mark.parametrize("bad", [b"\x20\x00", b"\x30" + bytes(10), b"\xff\xff\xff\xff" + bytes(5)])
def test_v1_header_errors_equal_the_jax_package(bad):
    for port_call, ref_call in ((fh.FrameHeader.decode, jax_fh.FrameHeader.decode),
                                (fh.get_encoding_flag, jax_fh.get_encoding_flag)):
        got = want = None
        try:
            port_call(bad)
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            got = (type(e).__name__, str(e))
        try:
            ref_call(bad)
        except Exception as e:  # noqa: BLE001
            want = (type(e).__name__, str(e))
        assert got == want


V2_CASES = [
    dict(),
    dict(id=5, bitrate=20000),
    dict(id=2**64 - 1, crc=True),
    dict(bitrate=64000, crc=True, flags=1, big=True),
    dict(id=0, bitrate=0, crc=True, flags=0x0F),
]


@pytest.mark.parametrize("case", V2_CASES)
def test_v2_header_encodes_and_decodes_like_the_jax_package(case):
    payload = bytes(range(37))
    (pe, je), (pn, jn) = _both("OPUS"), _endian(case.get("big", False))
    port = fh.FrameHeaderV2(pe, len(payload), 960, 48000, 2, 16, pn, id=case.get("id"),
                            bitrate=case.get("bitrate"), packet_flags=case.get("flags", 0))
    ref = jax_fh.FrameHeaderV2(je, len(payload), 960, 48000, 2, 16, jn, id=case.get("id"),
                               bitrate=case.get("bitrate"), packet_flags=case.get("flags", 0))
    if case.get("crc"):
        port, ref = port.with_packet_crc32(payload), ref.with_packet_crc32(payload)
    data = port.encode()
    assert data == ref.encode() and len(data) == port.size() == ref.size()
    assert fh.FrameHeaderV2.header_size(data) == jax_fh.FrameHeaderV2.header_size(data) == len(data)
    assert _fields(fh.FrameHeaderV2.decode(data)) == _fields(jax_fh.FrameHeaderV2.decode(data))
    got = fh.FrameHeaderV2.decode(data)
    assert got.is_encrypted == bool(case.get("flags", 0) & 1)
    assert got.verify_packet_crc32(payload) and \
        got.verify_packet_crc32(payload[:-1]) == (not case.get("crc"))


# ---------------------------------------------------------------------------
# the frame stream
# ---------------------------------------------------------------------------

def _frames(mod_fh, mod_fs, mod_types, cipher=None, n=6):
    """``n`` v2 frames of seeded payloads through ``encode_frame`` (CRC on;
    encrypted under ``cipher`` with fixed nonces where given)."""
    rng = np.random.default_rng(11)
    out, payloads = [], []
    for i in range(n):
        payload = rng.integers(0, 256, int(rng.integers(1, 400))).astype(np.uint8).tobytes()
        payloads.append(payload)
        wire = payload
        flags = 0
        if cipher is not None:
            wire = cipher.encrypt_nonce_prefixed(bytes([i]) * 12, payload, b"")
            flags = mod_fh.FLAG_ENCRYPTED
        h = mod_fh.FrameHeaderV2(mod_types.EncodingFlag.OPUS, len(wire), 960, 48000, 2, 0,
                                 id=i if i % 2 else None, bitrate=64000 if i % 3 else None)
        h = h.with_packet_flags(flags).with_packet_crc32(wire)
        out.append(mod_fs.encode_frame(h, wire))
    return b"".join(out), payloads


def _push_chunks(stream, data: bytes, chunk: int):
    frames = []
    for i in range(0, len(data), chunk):
        frames.extend(stream.push(data[i:i + chunk]))
    return frames


def _frame_fields(f) -> tuple:
    return (_fields(f.header), f.payload, f.encrypted, f.encoded_header_bytes,
            f.encrypted_payload_size)


@pytest.mark.parametrize("encrypted", [False, True])
@pytest.mark.parametrize("chunk", [1, 7, 313])
def test_frame_stream_gives_the_jax_packages_frames(chunk, encrypted):
    pc = crypto.ChaCha20Poly1305PacketCipher.new_from_decimal_key(KEY_DECIMAL) if encrypted else None
    jc = jax_crypto.ChaCha20Poly1305PacketCipher.new_from_decimal_key(KEY_DECIMAL) \
        if encrypted else None
    wire, payloads = _frames(fh, fs, audio_types, pc)
    ref_wire, _ = _frames(jax_fh, jax_fs, jax_types, jc)
    assert wire == ref_wire
    port = fs.SoundKitFrameStream(fs.SoundKitFrameStreamOptions(cipher=pc))
    ref = jax_fs.SoundKitFrameStream(jax_fs.SoundKitFrameStreamOptions(cipher=jc))
    got, want = _push_chunks(port, wire, chunk), _push_chunks(ref, wire, chunk)
    assert [f.payload for f in got] == payloads
    assert [_frame_fields(f) for f in got] == [_frame_fields(f) for f in want]
    assert all(f.encrypted == encrypted for f in got)
    assert port.buffered_bytes == ref.buffered_bytes == 0
    port.finish()


def _error_of(stream, data: bytes, chunk: int, finish: bool):
    try:
        _push_chunks(stream, data, chunk)
        if finish:
            stream.finish()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("fault", ["crc", "no_cipher", "partial_tail", "bad_magic", "oversize"])
@pytest.mark.parametrize("chunk", [1, 7, 313])
def test_frame_stream_errors_equal_the_jax_packages(fault, chunk):
    pc = crypto.ChaCha20Poly1305PacketCipher(KEY)
    wire, _ = _frames(fh, fs, audio_types, pc if fault == "no_cipher" else None, n=3)
    if fault == "crc":
        wire = bytearray(wire)
        wire[-1] ^= 0xFF
        wire = bytes(wire)
    elif fault == "partial_tail":
        wire = wire + wire[:10]
    elif fault == "bad_magic":
        wire = b"\x00" + wire[1:]
    opts = dict(max_payload_bytes=100) if fault == "oversize" else {}
    port = fs.SoundKitFrameStream(fs.SoundKitFrameStreamOptions(**opts))
    ref = jax_fs.SoundKitFrameStream(jax_fs.SoundKitFrameStreamOptions(**opts))
    got = _error_of(port, wire, chunk, finish=True)
    assert got is not None and got[0] == "FrameStreamError"
    assert got == _error_of(ref, wire, chunk, finish=True)


# ---------------------------------------------------------------------------
# the packet cipher, the ACE1 envelope and the key unwrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [KEY_DECIMAL, " 1 ", "0", str(2**256 - 1), str(2**256), "12a4", ""])
def test_decimal_keys_parse_like_the_jax_package(text):
    def run(mod):
        try:
            return mod.key_from_decimal(text)
        except Exception as e:  # noqa: BLE001
            return type(e).__name__, str(e)

    assert run(crypto) == run(jax_crypto)


@pytest.mark.parametrize("size", [0, 1, 960, 4000])
def test_packet_cipher_ciphertexts_equal_the_jax_packages(size):
    plaintext = np.random.default_rng(size).integers(0, 256, size).astype(np.uint8).tobytes()
    nonce, aad = bytes(range(12)), b"soundkit-v2-header"
    port = crypto.ChaCha20Poly1305PacketCipher(KEY)
    ref = jax_crypto.ChaCha20Poly1305PacketCipher(KEY)
    packet = port.encrypt_nonce_prefixed(nonce, plaintext, aad)
    assert packet == ref.encrypt_nonce_prefixed(nonce, plaintext, aad)
    assert len(packet) == size + crypto.PACKET_OVERHEAD_BYTES
    assert port.decrypt_nonce_prefixed(packet, aad) == plaintext
    with pytest.raises(crypto.DecryptFailed):
        port.decrypt_nonce_prefixed(packet, b"wrong")
    with pytest.raises(crypto.PacketTooShort):
        port.decrypt_nonce_prefixed(packet[:27], aad)
    with pytest.raises(crypto.InvalidNonceLength):
        port.encrypt_nonce_prefixed(nonce[:8], plaintext, aad)
    with pytest.raises(crypto.InvalidKeyLength):
        crypto.ChaCha20Poly1305PacketCipher(KEY[:31])


def _metadata(mod, **kw):
    base = dict(session_context=b"ses_example", transport_session_id=1, config_generation=2,
                epoch_id=3, pts_samples=4, sample_rate=48000, frame_count=240, group_count=2,
                group_id=7, group_index=1, channel_start=16, channel_count=2, payload_kind=3,
                sample_format=2, flags=0x81)
    base.update(kw)
    return mod.AudioGroupMetadata(**base)


@pytest.mark.parametrize("change", [{}, dict(group_id=8), dict(flags=0x01),
                                    dict(session_context=b"x" * 128), dict(pts_samples=2**63)])
def test_group_metadata_aad_equals_the_jax_packages(change):
    assert _metadata(ace, **change).associated_data() == _metadata(jax_ace, **change).associated_data()


@pytest.mark.parametrize("size", [0, 11, 5000])
def test_ace1_seal_and_open_equal_the_jax_package(size):
    plaintext = np.random.default_rng(size).integers(0, 256, size).astype(np.uint8).tobytes()
    nonce = bytes([0x07, 0, 0, 0, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47])
    aad = _metadata(ace).associated_data()
    port, ref = ace.AudioContentCipher(KEY), jax_ace.AudioContentCipher(KEY)
    env = port.seal(7, nonce, plaintext, aad)
    assert env == ref.seal(7, nonce, plaintext, aad)
    assert env[:4] == b"ACE1" and len(env) == size + ace.ENVELOPE_OVERHEAD_BYTES
    assert port.open(7, env, aad) == ref.open(7, env, aad) == plaintext


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("fault", ["zero_key", "short_key", "epoch0_seal", "epoch0_open",
                                   "mismatch", "tamper", "aad", "short", "magic"])
def test_ace1_errors_equal_the_jax_packages(fault):
    nonce = bytes(12)

    def run(mod):
        cipher = mod.AudioContentCipher(KEY)
        env = bytearray(cipher.seal(7, nonce, b"audio", b"metadata"))
        if fault == "zero_key":
            return _outcome(lambda: mod.AudioContentCipher(bytes(32)))
        if fault == "short_key":
            return _outcome(lambda: mod.AudioContentCipher(KEY[:16]))
        if fault == "epoch0_seal":
            return _outcome(lambda: cipher.seal(0, nonce, b"audio", b""))
        if fault == "epoch0_open":
            return _outcome(lambda: cipher.open(0, bytes(env), b"metadata"))
        if fault == "mismatch":
            return _outcome(lambda: cipher.open(8, bytes(env), b"metadata"))
        if fault == "tamper":
            env[-1] ^= 0x80
        elif fault == "aad":
            return _outcome(lambda: cipher.open(7, bytes(env), b"other"))
        elif fault == "short":
            env = env[:30]
        elif fault == "magic":
            env[0] ^= 1
        return _outcome(lambda: cipher.open(7, bytes(env), b"metadata"))

    got = run(ace)
    assert got[0] != "ok" and got == run(jax_ace)


# ---------------------------------------------------------------------------
# v1 audio packets
# ---------------------------------------------------------------------------

def _pcm_bytes(fmt: str, n: int, channels: int) -> bytes:
    rng = np.random.default_rng(n + channels)
    x = 0.6 * np.sin(np.arange(n * channels) * 0.013) + 0.05 * rng.standard_normal(n * channels)
    x[::97] = 1.0  # full scale, where every conversion clips or rounds
    if fmt == "s16":
        return np.clip(np.rint(x * 32767), -32768, 32767).astype("<i2").tobytes()
    if fmt == "s24":
        v = np.clip(np.rint(x * 8388607), -8388608, 8388607).astype("<i4")
        return b"".join(int(s).to_bytes(4, "little", signed=True)[:3] for s in v)
    if fmt == "s32":
        return np.clip(np.rint(x * 2147483647), -2**31, 2**31 - 1).astype("<i4").tobytes()
    return x.astype("<f4").tobytes()


_SOURCES = {"s16": ("PCM_SIGNED", 16), "s24": ("PCM_SIGNED", 24), "s32": ("PCM_SIGNED", 32),
            "f32": ("PCM_FLOAT", 32)}


class _OpusI16:
    """``decode_i16`` of an audio packet: the owned decoder, one packet."""

    def __init__(self, mod, channels: int):
        self._dec = mod.OpusDecoder(channels)

    def decode_i16(self, data):
        pcm = np.asarray(self._dec.decode_packet(data), np.float64).reshape(-1)
        return np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype(np.int16)


# (source, target): FLAC packets from the 16- and 24-bit sources at their
# depth, Opus packets from every source (each converted to int16), float
# packets passed through
ENCODE_CASES = [("s16", "FLAC"), ("s24", "FLAC")] + \
    [(src, t) for t in ("OPUS", "PCM_FLOAT") for src in _SOURCES]


@pytest.mark.parametrize("source,target", ENCODE_CASES)
def test_audio_packet_encode_equals_the_jax_packages(source, target):
    enc, bits = _SOURCES[source]
    n, channels = 960, 2
    body = _pcm_bytes(source, n, channels)
    pe, je = _both(enc)

    def encoder(mod):
        if target == "FLAC":
            return mod.FlacEncoder(48000, bits, channels, frame_size=n)
        if target == "OPUS":
            return OpusPacketEncoder(mod, channels)
        return None

    port = audio_packet.encode_audio_packet(
        _both(target)[0], encoder(encoders),
        fh.FrameHeader(pe, n, 48000, channels, bits, id=9).encode() + body)
    ref = jax_packet.encode_audio_packet(
        _both(target)[1], encoder(jax_encoders),
        jax_fh.FrameHeader(je, n, 48000, channels, bits, id=9).encode() + body)
    assert port == ref and len(port) > 17
    assert fh.get_encoding_flag(port).name == target


@pytest.mark.parametrize("source", list(_SOURCES) + ["opus"])
def test_audio_packet_decode_equals_the_jax_packages(source):
    n, channels = 960, 2
    if source == "opus":
        samples = np.frombuffer(_pcm_bytes("s16", 2 * n, channels), "<i2")
        packets = encoders.OpusEncoder(48000, channels, 64000).encode_i16_packets(samples)
        data = (fh.FrameHeader(audio_types.EncodingFlag.OPUS, n, 48000, channels, 16).encode()
                + packets[0])
        port = audio_packet.decode_audio_packet(data, _OpusI16(opus_core, channels))
        ref = jax_packet.decode_audio_packet(data, _OpusI16(jax_opus_core, channels))
        assert max(np.abs(c).max() for c in port.channels) > 0.1
    else:
        enc, bits = _SOURCES[source]
        data = fh.FrameHeader(_both(enc)[0], n, 48000, channels, bits).encode() + \
            _pcm_bytes(source, n, channels)
        port = audio_packet.decode_audio_packet(data)
        ref = jax_packet.decode_audio_packet(data)
    assert (port.sample_count, port.sampling_rate) == (ref.sample_count, ref.sampling_rate) == \
        (n, 48000)
    assert len(port.channels) == len(ref.channels) == channels
    for g, w in zip(port.channels, ref.channels):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["decode_s8", "decode_aac", "encode_flac_s8", "encode_opus_s8",
                                  "encode_other"])
def test_audio_packet_refuses_what_the_jax_package_refuses(case):
    def run(mod_packet, mod_fh, mod_types, mod_enc):
        flag = mod_types.EncodingFlag
        bits = 16 if case == "decode_aac" else 8
        enc = flag.AAC if case == "decode_aac" else flag.PCM_SIGNED
        data = mod_fh.FrameHeader(enc, 4, 48000, 1, bits).encode() + bytes(8)
        if case.startswith("decode"):
            return _outcome(lambda: mod_packet.decode_audio_packet(data))
        target = {"encode_flac_s8": flag.FLAC, "encode_opus_s8": flag.OPUS,
                  "encode_other": flag.PCM_SIGNED}[case]
        return _outcome(lambda: mod_packet.encode_audio_packet(target, None, data))

    got = run(audio_packet, fh, audio_types, encoders)
    want = run(jax_packet, jax_fh, jax_types, jax_encoders)
    assert got == want
    # an unknown target keeps the header and no data, as in the JAX package
    assert (got[0] == "ok") == (case == "encode_other")
    if case == "encode_other":
        assert len(got[1]) == 9
    else:
        assert got[0] == "AudioPacketError"
