"""Port parity of the encoders and the rest of ``simple.py``:
``codecs/encoders.FlacEncoder`` (frames and ``streaminfo``),
``AudioEncoder``'s packet container, ``adts_header``, and the five
classes ``simple.FlacEncoder``, ``OpusEncoder``, ``AudioContentCipher``,
``SoundKitFrameDecoder`` and ``AudioContentKeyUnwrapper``, each against
the JAX package's on the same seeded numpy input, with equal bytes. The
FLAC frames decode back to their source samples through the port's
decoder. The libavcodec encoders of the JAX package (``AvEncoder``,
``AacEncoder``, ``Mp3Encoder``) raise ``EncodeError`` at construction in
the port: a stated departure, held here."""
import struct

import numpy as np
import pytest

from soundkit_tpu import simple as jax_simple
from soundkit_tpu.codecs import encoders as jax_encoders
from soundkit_tpu.core import audio_types as jax_types
from soundkit_tpu.core import frame_header as jax_fh
from soundkit_tpu.core import frame_stream as jax_fs
from soundkit_tpu.core import wav as jax_wav
from soundkit_tpu_torch import simple
from soundkit_tpu_torch.codecs import encoders
from soundkit_tpu_torch.codecs.flac import FlacDecoder
from soundkit_tpu_torch.core import audio_types, crypto, wav
from soundkit_tpu_torch.core import frame_header as fh
from soundkit_tpu_torch.core import frame_stream as fs

from torch_port_helpers import OpusPacketEncoder

KEY_DECIMAL = "83843157117408337365446905028299378179116700186920144823595584430653437972238"


def _ints(n: int, channels: int, bits: int, seed: int = 0) -> np.ndarray:
    """Interleaved ints at ``bits``: tones, noise, a silent stretch and
    full-scale runs (the fixed and LPC subframes, the constant one and
    the Rice escapes all get used)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.5 * np.sin(0.021 * t) + 0.2 * np.sin(0.37 * t) + 0.03 * rng.standard_normal(n)
    x[n // 3: n // 3 + 600] = 0.0
    x[n // 2: n // 2 + 50] = 1.0
    full = (1 << (bits - 1)) - 1
    ch = [x, np.roll(x, 5) * 0.7 + 0.01 * rng.standard_normal(n)][:channels]
    return np.clip(np.rint(np.stack(ch, axis=1) * full), -full - 1, full).astype(np.int64).reshape(-1)


# ---------------------------------------------------------------------------
# FlacEncoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [0, 5, 8])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [16, 24])
def test_flac_encoder_writes_the_jax_packages_frames(bits, channels, level):
    """Two pushes: whole frames and a short frame of >= 16 samples, then
    a sub-16 tail held for ``flush``, which pads it with its last value."""
    x = _ints(4096 + 1000 + 7, channels, bits, seed=bits + channels + level)
    cut = (4096 + 1000) * channels
    port = encoders.FlacEncoder(44100, bits, channels, compression_level=level)
    ref = jax_encoders.FlacEncoder(44100, bits, channels, compression_level=level)
    got = [port.encode_i32(x[:cut]), port.encode_i32(x[cut:]), port.flush(), port.flush()]
    want = [ref.encode_i32(x[:cut]), ref.encode_i32(x[cut:]), ref.flush(), ref.flush()]
    assert got == want
    assert got[1] == b"" and got[2] != b"" and got[3] == b""
    assert port.streaminfo == ref.streaminfo and len(port.streaminfo) == 34
    # the frames decode back to the source (and the tail's padding)
    stream = b"fLaC" + bytes([0x80, 0, 0, 34]) + port.streaminfo + b"".join(got)
    data = FlacDecoder().add(stream).data
    if bits == 16:
        pcm = np.frombuffer(data, "<i2").astype(np.int64)
    else:
        raw = np.frombuffer(data, np.uint8).reshape(-1, 3).astype(np.int64)
        pcm = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
        pcm = np.where(pcm >= 1 << 23, pcm - (1 << 24), pcm)
    pad = np.tile(x[-channels:], 16 - 7)  # the last frame, held
    np.testing.assert_array_equal(pcm, np.concatenate([x, pad]))


@pytest.mark.parametrize("bits", [16, 24])
def test_flac_encoder_i16_input_equals_the_jax_packages(bits):
    x = _ints(3000, 2, 16, seed=4)
    port = encoders.FlacEncoder(48000, bits, 2, frame_size=1152, compression_level=2)
    ref = jax_encoders.FlacEncoder(48000, bits, 2, frame_size=1152, compression_level=2)
    assert port.encode_i16(x) + port.flush() == ref.encode_i16(x) + ref.flush()
    assert port.streaminfo == ref.streaminfo


# ---------------------------------------------------------------------------
# AudioEncoder and the ADTS header
# ---------------------------------------------------------------------------

def _wav_bytes(mod_wav, mod_types, n: int, rate: int, seed: int) -> bytes:
    x = _ints(n, 2, 16, seed=seed).astype(np.int16)
    return mod_wav.generate_wav_buffer(mod_types.PcmData.i16([x[0::2], x[1::2]]), rate)


@pytest.mark.parametrize("target", ["FLAC", "OPUS", "PCM_FLOAT"])
@pytest.mark.parametrize("chunk", [1000, 4099])
def test_audio_encoder_container_equals_the_jax_packages(target, chunk):
    rate = 48000
    frame = 960

    def run(mod_enc, mod_wav, mod_types):
        enc = {"FLAC": lambda: mod_enc.FlacEncoder(rate, 16, 2, frame_size=frame),
               "OPUS": lambda: OpusPacketEncoder(mod_enc), "PCM_FLOAT": lambda: None}[target]()
        ae = mod_enc.AudioEncoder(mod_types.EncodingFlag[target], frame, enc)
        data = _wav_bytes(mod_wav, mod_types, 3 * frame + 200, rate, seed=chunk)
        for i in range(0, len(data), chunk):
            ae.add(data[i:i + chunk])
        first = ae.flush()
        for i in range(0, len(data), chunk):  # a second stream after the flush
            ae.add(data[i:i + chunk])
        return first, ae.flush()

    got = run(encoders, wav, audio_types)
    assert got == run(jax_encoders, jax_wav, jax_types)
    blob = got[0]
    count = struct.unpack_from("<I", blob, 0)[0]
    assert count == 4  # three whole frames and the widow at the flush
    offsets = struct.unpack_from(f"<{count}I", blob, 4)
    payload = blob[4 + 4 * count:]
    for off in offsets:
        h = fh.FrameHeader.decode(payload[off:])
        assert h.encoding.name == target and (h.sample_rate, h.channels) == (rate, 2)


@pytest.mark.parametrize("args", [(100, 8, 2), (0, 3, 1), (8184, 0, 7, 2), (2000, 11, 2, 0)])
def test_adts_header_equals_the_jax_packages(args):
    assert encoders.adts_header(*args) == jax_encoders.adts_header(*args)
    assert encoders.ADTS_SAMPLE_RATES == jax_encoders.ADTS_SAMPLE_RATES


@pytest.mark.parametrize("make", [
    lambda m: m.AvEncoder("aac", 48000, 2, 128000),
    lambda m: m.AacEncoder(48000, 2),
    lambda m: m.AacEncoder(44100, 1, 96000),
    lambda m: m.Mp3Encoder(44100, 2),
    lambda m: m.OpusEncoder(24000, 1),
    lambda m: m.OpusEncoder(16000, 1),
    lambda m: m.OpusEncoder(48000, 2, backend="libopus"),
    lambda m: m.OpusEncoder(48000, 3),
])
def test_libavcodec_encoders_raise_encode_error(make):
    """A stated departure: each opens libavcodec in the JAX package (the
    Opus encoder at another rate than 48 kHz, for another channel count or
    on request); the port builds no libavcodec and raises ``EncodeError``
    at construction."""
    with pytest.raises(encoders.EncodeError, match="libavcodec"):
        make(encoders)


def test_aac_encoder_refuses_a_rate_before_it_reaches_libavcodec():
    for mod in (encoders, jax_encoders):
        with pytest.raises(mod.EncodeError, match="unsupported AAC sample rate 12345"):
            mod.AacEncoder(12345, 2)


# ---------------------------------------------------------------------------
# simple.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("channels", [1, 2])
def test_simple_flac_encoder_equals_the_jax_packages(channels, bits):
    rng = np.random.default_rng(channels * bits)
    n = 5000
    t = np.arange(n * channels)
    planar = (0.7 * np.sin(0.02 * t) + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
    planar[::301] = 1.5  # beyond full scale: clipped
    port = simple.FlacEncoder(16000, channels, bits_per_sample=bits, compression_level=8)
    ref = jax_simple.FlacEncoder(16000, channels, bits_per_sample=bits, compression_level=8)
    got = [port.encode_planar_f32(planar, 3000), port.encode_planar_f32(planar[3000:], 1000),
           port.flush()]
    assert got == [ref.encode_planar_f32(planar, 3000), ref.encode_planar_f32(planar[3000:], 1000),
                   ref.flush()]
    port.reset()
    ref.reset()
    assert port.encode_planar_f32(planar, 100) + port.flush() == \
        ref.encode_planar_f32(planar, 100) + ref.flush()
    with pytest.raises(ValueError, match="too short"):
        port.encode_planar_f32(planar[:10], 100)


@pytest.mark.parametrize("channels", [1, 2])
def test_simple_opus_encoder_equals_the_jax_packages(channels):
    port, ref = simple.OpusEncoder(48000, channels, 64000), jax_simple.OpusEncoder(48000, channels, 64000)
    assert port.frame_size == ref.frame_size == 960
    x = _ints(960 * 6, channels, 16, seed=channels).astype(np.int16)
    got, want = [], []
    for k in range(6):
        part = x[k * 960 * channels:(k + 2) * 960 * channels]  # longer input: cut to a frame
        got += port.encode_interleaved_i16(part)
        want += ref.encode_interleaved_i16(part)
    got += port.flush()
    want += ref.flush()
    assert got == want and len(got) == 6
    port.reset()
    ref.reset()
    assert port.encode_interleaved_i16(x) + port.flush() == ref.encode_interleaved_i16(x) + ref.flush()
    with pytest.raises(ValueError, match="too short"):
        port.encode_interleaved_i16(x[:10])


def test_simple_audio_content_cipher_equals_the_jax_packages():
    key = bytes(range(32))
    port, ref = simple.AudioContentCipher(key), jax_simple.AudioContentCipher(key)
    for i, size in enumerate((0, 11, 3000)):
        plaintext = bytes(np.random.default_rng(size).integers(0, 256, size).astype(np.uint8))
        nonce, aad = bytes([i]) * 12, b"aad-%d" % i
        env = port.seal(7 + i, nonce, plaintext, aad)
        assert env == ref.seal(7 + i, nonce, plaintext, aad)
        assert port.open(7 + i, env, aad) == ref.open(7 + i, env, aad) == plaintext
    with pytest.raises(Exception, match="does not match expected epoch"):
        port.open(8, env, aad)
    with pytest.raises(Exception, match="must not be all zero"):
        simple.AudioContentCipher(bytes(32))


def _v2_wire(mod_fh, mod_fs, mod_types, payloads, cipher=None):
    out = []
    for i, p in enumerate(payloads):
        wire, flags = p, 0
        if cipher is not None:
            wire, flags = cipher.encrypt_nonce_prefixed(bytes([i + 1]) * 12, p, b""), 1
        h = mod_fh.FrameHeaderV2(mod_types.EncodingFlag.OPUS, len(wire), 960, 48000, 2, 0, id=i)
        out.append(mod_fs.encode_frame(h.with_packet_flags(flags).with_packet_crc32(wire), wire))
    return b"".join(out)


@pytest.mark.parametrize("decimal_key", [None, KEY_DECIMAL])
@pytest.mark.parametrize("chunk", [1, 313])
def test_simple_frame_decoder_equals_the_jax_packages(chunk, decimal_key):
    payloads = [bytes(np.random.default_rng(i).integers(0, 256, 20 + 37 * i).astype(np.uint8))
                for i in range(5)]
    cipher = crypto.ChaCha20Poly1305PacketCipher.new_from_decimal_key(decimal_key) \
        if decimal_key else None
    data = _v2_wire(fh, fs, audio_types, payloads, cipher)
    assert data == _v2_wire(jax_fh, jax_fs, jax_types, payloads,
                            jax_simple.ChaCha20Poly1305PacketCipher.new_from_decimal_key(decimal_key)
                            if decimal_key else None)
    port = simple.SoundKitFrameDecoder(decimal_key)
    ref = jax_simple.SoundKitFrameDecoder(decimal_key)
    got, want = [], []
    for i in range(0, len(data), chunk):
        got += port.push(data[i:i + chunk])
        want += ref.push(data[i:i + chunk])
    assert [f.payload for f in got] == [f.payload for f in want] == payloads
    assert [(f.header.id, f.encrypted, f.encoded_header_bytes, f.encrypted_payload_size)
            for f in got] == [(f.header.id, f.encrypted, f.encoded_header_bytes,
                               f.encrypted_payload_size) for f in want]
    assert port.flush() == [] and ref.flush() == []
    port.push(data[:20])
    with pytest.raises(fs.FrameStreamError, match="buffered bytes"):
        port.flush()


def test_simple_key_unwrapper_equals_the_jax_packages():
    wrap = bytes(range(1, 33))
    port, ref = simple.AudioContentKeyUnwrapper(wrap), jax_simple.AudioContentKeyUnwrapper(wrap)
    nonce, content_key = bytes(range(12)), bytes(range(100, 132))
    sealed = port.seal(nonce, content_key, b"kex context")
    assert sealed == ref.seal(nonce, content_key, b"kex context") and len(sealed) == 48
    assert port.open(nonce, sealed, b"kex context") == content_key
    for call in (lambda u: u.open(nonce[:8], sealed, b"kex context"),
                 lambda u: u.open(nonce, sealed[:47], b"kex context"),
                 lambda u: u.seal(nonce, bytes(32), b"")):
        with pytest.raises(ValueError) as got:
            call(port)
        with pytest.raises(ValueError) as want:
            call(ref)
        assert str(got.value) == str(want.value)
    with pytest.raises(crypto.DecryptFailed):
        port.open(nonce, sealed, b"other context")
    with pytest.raises(ValueError, match="wrapping key"):
        simple.AudioContentKeyUnwrapper(bytes(32))
