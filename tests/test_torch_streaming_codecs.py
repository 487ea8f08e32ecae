"""Port parity: the port's streaming host codecs against the JAX
package's on the CPU, on the same bytes, fed whole and in odd chunks.

G.711, G.722 and G.726 bit-exact (decode in i16 / i32 / f32, encode
with the G.722 odd-sample carry and the G.726 group buffering, the
G.722 / G.726 state equal to the JAX decoders' after every chunk);
FLAC bit-exact with its STREAMINFO MD5; MP3 at >= 100 dB, within 1 LSB
in int16 and its overlap and FIFO within 1e-5 of their largest value;
AAC-ADTS bit-exact. The shapes the JAX package hands to libavcodec
raise in the port, but MPEG audio Layer I / II, which the port decodes
with its owned host decoder (``tests/test_torch_mpa.py``). The telephony clips are cut short: the plain scans
step one sample at a time on the CPU (about 1.3 ms a G.722 code and 2
ms a G.726 code)."""
from pathlib import Path

import numpy as np
import pytest
import torch

from soundkit_tpu.codecs import aac as jax_aac
from soundkit_tpu.codecs import flac as jax_flac
from soundkit_tpu.codecs import g711 as jax_g711
from soundkit_tpu.codecs import g722 as jax_g722
from soundkit_tpu.codecs import g726 as jax_g726
from soundkit_tpu.codecs import mp3 as jax_mp3
from soundkit_tpu_torch.codecs import aac, flac, g711, g722, g726, mp3
from soundkit_tpu_torch.ops.adpcm import G726_LAYOUT
from soundkit_tpu_torch.ops.g722 import G722_LAYOUT
from soundkit_tpu_torch.pipeline.output_options import DecodingFailed, UnsupportedFormat
from soundkit_tpu_torch.tools import aac_fixtures, flac_fixtures, mp3_fixtures
from soundkit_tpu_torch.tools import telephony_fixtures as tfx

from torch_port_helpers import snr_db

DATA = Path(__file__).resolve().parent / "data" / "torch_port"
AAC_CLIPS = sorted(p.name for p in DATA.glob("*.aac"))
MP3_CLIPS = [c.name for c in mp3_fixtures.load_clips()]
FLAC_CLIPS = [c.name for c in flac_fixtures.load_clips()]

# telephony cuts: G.711 1 s; G.722 0.25 s (2000 codes); G.726 0.15 s
G711_BYTES = 8000
G722_BYTES = 2000
G726_SAMPLES = 1200


def chunks(data, size: int, prefix_ones: int = 0):
    """``data`` in chunks of ``size``, after ``prefix_ones`` 1-element chunks."""
    out = [data[i:i + 1] for i in range(min(prefix_ones, len(data)))]
    return out + [data[i:i + size] for i in range(prefix_ones, len(data), size)]


FEEDS = {"whole": (1 << 30, 0), "313": (313, 0), "137": (137, 0), "ones": (137, 24)}


def _feed(data, feed: str):
    size, ones = FEEDS[feed]
    return chunks(data, size, ones)


# ---------------------------------------------------------------------------
# G.711
# ---------------------------------------------------------------------------

LAWS = [(g711.G711Law.MU_LAW, jax_g711.G711Law.MU_LAW, "g711_mulaw"),
        (g711.G711Law.A_LAW, jax_g711.G711Law.A_LAW, "g711_alaw")]


@pytest.mark.parametrize("law,jax_law,codec", LAWS, ids=["mulaw", "alaw"])
@pytest.mark.parametrize("feed", list(FEEDS))
def test_g711_decode_matches_jax(law, jax_law, codec, feed):
    data = b"".join(c[:G711_BYTES] for c in tfx.load_clips(codec))
    port = g711.G711Decoder(law, device="cpu")
    ref = jax_g711.G711Decoder(jax_law)
    for part in _feed(data, feed):
        np.testing.assert_array_equal(port.decode_i16(part), ref.decode_i16(part))
        got = port.decode_i32(part)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref.decode_i32(part))
        got = port.decode_f32(part)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref.decode_f32(part))


@pytest.mark.parametrize("law,jax_law,codec", LAWS, ids=["mulaw", "alaw"])
def test_g711_encode_and_scalars_match_jax(law, jax_law, codec):
    pcm = np.concatenate([c[:G711_BYTES] for c in tfx.pcm_clips(8000)])
    pcm = np.concatenate([pcm, np.array([-32768, -1, 0, 1, 32767], np.int16)])
    port = g711.G711Encoder(law, device="cpu")
    ref = jax_g711.G711Encoder(jax_law)
    for part in chunks(pcm, 313, 5):
        assert port.encode_i16(part) == ref.encode_i16(part)
    wide = pcm.astype(np.int32) << 16 | 0x1234
    assert port.encode_i32(wide) == ref.encode_i32(wide)
    for code in range(256):
        assert g711.decode_sample(law, code, "cpu") == jax_g711.decode_sample(jax_law, code)
    for s in (-32768, -5000, -33, -1, 0, 1, 33, 5000, 32767):
        assert g711.encode_sample(law, s, "cpu") == jax_g711.encode_sample(jax_law, s)


# ---------------------------------------------------------------------------
# G.722
# ---------------------------------------------------------------------------

def _g722_wire():
    return tfx.load_clips("g722")[0][:G722_BYTES]


@pytest.mark.parametrize("feed", ["whole", "313", "ones"])
def test_g722_decode_and_state_match_jax(feed):
    data = _g722_wire()
    port = g722.G722Decoder("cpu")
    ref = jax_g722.G722Decoder()
    for part in _feed(data, feed):
        got = port.decode_i16(part)
        assert got.dtype == np.int16 and len(got) == 2 * len(part)
        np.testing.assert_array_equal(got, ref.decode_i16(part))
        assert torch.equal(port._state, G722_LAYOUT.from_jax(ref._state, "cpu"))


def test_g722_decode_i32_f32_and_reset():
    data = _g722_wire()[:300]
    port, ref = g722.G722Decoder("cpu"), jax_g722.G722Decoder()
    np.testing.assert_array_equal(port.decode_i32(data[:127]), ref.decode_i32(data[:127]))
    got = port.decode_f32(data[127:])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref.decode_f32(data[127:]))
    port.reset()
    ref.reset()
    np.testing.assert_array_equal(port.decode_i16(data[:40]), ref.decode_i16(data[:40]))
    assert port.sample_rate == 16000 and port.channels == 1


def test_g722_encode_odd_carry_flush_and_state_match_jax():
    pcm = tfx.pcm_clips(16000)[3][:2 * G722_BYTES + 1]  # an odd total
    port, ref = g722.G722Encoder("cpu"), jax_g722.G722Encoder()
    for part in chunks(pcm, 313, 3):  # odd chunks: the carry alternates
        assert port.encode_i16(part) == ref.encode_i16(part)
        assert len(port._pending) == len(ref._pending) <= 1
        assert torch.equal(port._state, G722_LAYOUT.from_jax(ref._state, "cpu"))
    assert len(port._pending) == 1
    tail = port.flush()
    assert len(tail) == 1 and tail == ref.flush()
    assert torch.equal(port._state, G722_LAYOUT.from_jax(ref._state, "cpu"))
    assert port.flush() == b"" == ref.flush()
    wide = pcm[:255].astype(np.int32) << 16
    assert port.encode_i32(wide) == ref.encode_i32(wide)


def test_g722_encoder_never_hands_k7_an_odd_count(monkeypatch):
    from soundkit_tpu_torch.ops import g722 as g722_ops

    seen = []
    plain = g722_ops.g722_encode_scan

    def spy(samples, state, valid=None):
        seen.append(samples.shape[1])
        return plain(samples, state, valid)

    monkeypatch.setattr(g722_ops, "g722_encode_scan", spy)
    enc = g722.G722Encoder("cpu")
    for n in (1, 1, 3, 127, 2, 313, 0, 5):
        enc.encode_i16(np.arange(n, dtype=np.int16) * 37)
    enc.flush()
    assert seen and all(n % 2 == 0 and n > 0 for n in seen)


# ---------------------------------------------------------------------------
# G.726
# ---------------------------------------------------------------------------

RATES = [(g726.G726Rate.RATE_16000, jax_g726.G726Rate.RATE_16000),
         (g726.G726Rate.RATE_24000, jax_g726.G726Rate.RATE_24000),
         (g726.G726Rate.RATE_32000, jax_g726.G726Rate.RATE_32000),
         (g726.G726Rate.RATE_40000, jax_g726.G726Rate.RATE_40000)]
PACKINGS = [(g726.G726Packing.LEFT, jax_g726.G726Packing.LEFT),
            (g726.G726Packing.RIGHT, jax_g726.G726Packing.RIGHT)]


def _g726_wire(rate, packing) -> bytes:
    """``G726_SAMPLES`` codes of the first clip, in ``packing`` (the fixtures are LEFT)."""
    bits = rate.bits_per_sample
    wire = tfx.load_clips(f"g726_{rate.bit_rate // 1000}")[0]
    codes = g726.unpack_codes(wire, bits, g726.G726Packing.LEFT)[:G726_SAMPLES]
    return g726.pack_codes(codes, bits, packing)


@pytest.mark.parametrize("rate,jax_rate", RATES, ids=lambda r: getattr(r, "name", ""))
@pytest.mark.parametrize("packing,jax_packing", PACKINGS, ids=["left", "right"])
def test_g726_decode_state_and_encode_match_jax(rate, jax_rate, packing, jax_packing):
    data = _g726_wire(rate, packing)
    port = g726.G726Decoder(rate, packing, device="cpu")
    ref = jax_g726.G726Decoder(jax_rate, jax_packing)
    for part in chunks(data, 137, 2):  # group boundaries fall inside chunks
        got = port.decode_i16(part)
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, ref.decode_i16(part))
        assert bytes(port._pending) == bytes(ref._pending)
        assert torch.equal(port._state, G726_LAYOUT.from_jax(ref._state, "cpu"))
    port.flush()
    ref.flush()

    pcm = tfx.pcm_clips(8000)[0][:G726_SAMPLES + 3]  # a partial group left over
    enc, ref_enc = g726.G726Encoder(rate, packing, device="cpu"), \
        jax_g726.G726Encoder(jax_rate, jax_packing)
    for part in chunks(pcm, 313, 1):
        assert enc.encode_i16(part) == ref_enc.encode_i16(part)
        assert torch.equal(enc._state, G726_LAYOUT.from_jax(ref_enc._state, "cpu"))
    tail = enc.flush()
    assert tail and tail == ref_enc.flush()
    assert torch.equal(enc._state, G726_LAYOUT.from_jax(ref_enc._state, "cpu"))


@pytest.mark.parametrize("rate,jax_rate", RATES[1::2], ids=["24k", "40k"])
def test_g726_whole_feed_i32_f32_and_partial_group_flush(rate, jax_rate):
    data = _g726_wire(rate, g726.G726Packing.LEFT)[:200]
    port = g726.G726Decoder(rate, device="cpu")
    ref = jax_g726.G726Decoder(jax_rate)
    np.testing.assert_array_equal(port.decode_i32(data[:101]), ref.decode_i32(data[:101]))
    np.testing.assert_array_equal(port.decode_f32(data[101:]), ref.decode_f32(data[101:]))
    group = rate.bytes_per_group
    port.reset()
    ref.reset()
    port.decode_i16(data[:group + 1])
    ref.decode_i16(data[:group + 1])
    with pytest.raises(ValueError, match="1 trailing partial-packet byte"):
        port.flush()
    with pytest.raises(ValueError, match="1 trailing partial-packet byte"):
        ref.flush()
    port.reset()
    ref.reset()
    np.testing.assert_array_equal(port.decode_i16(data[:group * 4]), ref.decode_i16(data[:group * 4]))
    wide = tfx.pcm_clips(8000)[1][:64].astype(np.int32) << 16
    assert g726.G726Encoder(rate, device="cpu").encode_i32(wide) == \
        jax_g726.G726Encoder(jax_rate).encode_i32(wide)


# ---------------------------------------------------------------------------
# FLAC
# ---------------------------------------------------------------------------

def _flac_decode(dec, data, feed):
    parts = [dec.add(p) for p in _feed(data, feed)]
    return [a for a in parts if a is not None]


@pytest.mark.parametrize("name", FLAC_CLIPS)
@pytest.mark.parametrize("feed", ["whole", "313", "ones"])
def test_flac_decoder_matches_jax_with_md5(name, feed):
    data = (DATA / "flac" / f"{name}.flac").read_bytes()
    port, ref = flac.FlacDecoder(), jax_flac.FlacDecoder()
    got, want = _flac_decode(port, data, feed), _flac_decode(ref, data, feed)
    assert [(a.data, a.sampling_rate, a.bits_per_sample, a.channel_count) for a in got] == \
        [(a.data, a.sampling_rate, a.bits_per_sample, a.channel_count) for a in want]
    pcm = b"".join(a.data for a in got)
    assert port.info == ref.info and port.info["md5"] != b"\x00" * 16
    assert port.verify_md5(pcm)
    assert not port.verify_md5(pcm[:-1] + bytes([pcm[-1] ^ 1]))


def test_decode_flac_and_its_errors_match_jax():
    data = (DATA / "flac" / "stereo24.flac").read_bytes()
    assert flac.decode_flac(data).data == jax_flac.decode_flac(data).data
    with pytest.raises(flac.FlacError):
        flac.decode_flac(data[:20])
    with pytest.raises(jax_flac.FlacError):
        jax_flac.decode_flac(data[:20])


# ---------------------------------------------------------------------------
# MP3
# ---------------------------------------------------------------------------

def _mp3_run(dec, data, feed):
    return np.concatenate([dec.decode_f32(p) for p in _feed(data, feed)] + [dec.flush_f32()])


def _assert_state_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    bound = 1e-5 * float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= bound


@pytest.mark.parametrize("name", MP3_CLIPS)
@pytest.mark.parametrize("feed", ["whole", "313", "ones"])
def test_mp3_decoder_matches_jax(name, feed):
    data = (DATA / "mp3" / f"{name}.mp3").read_bytes()
    port, ref = mp3.Mp3Decoder(device="cpu"), jax_mp3.Mp3Decoder()
    got, want = _mp3_run(port, data, feed), _mp3_run(ref, data, feed)
    assert ref._av is None  # the JAX package decoded on its owned path
    assert got.dtype == np.float32 and got.shape == want.shape and len(got) > 0
    assert (port.sample_rate, port.channels) == (ref.sample_rate, ref.channels)
    assert snr_db(got, want) >= 100.0
    i16 = np.abs(mp3.f32_to_i16(got).astype(np.int32) - jax_mp3.f32_to_i16(want).astype(np.int32))
    assert i16.max() <= 1
    _assert_state_close(port._state[0], ref._state[0])
    _assert_state_close(port._state[1], ref._state[1])


def test_mp3_state_tracks_jax_after_every_chunk():
    data = (DATA / "mp3" / "lsf22.mp3").read_bytes()[:6000]
    port, ref = mp3.Mp3Decoder(device="cpu"), jax_mp3.Mp3Decoder()
    compared = 0
    for part in chunks(data, 997):
        got, want = port.decode_f32(part), ref.decode_f32(part)
        assert got.shape == want.shape
        if len(want):
            assert snr_db(got, want) >= 100.0
            _assert_state_close(port._state[0], ref._state[0])
            _assert_state_close(port._state[1], ref._state[1])
            compared += 1
    assert compared >= 4


def _layer2_header(n_frames: int = 40) -> bytes:
    """MPEG-1 Layer II frames (44.1 kHz, 128 kbit/s), zero payload."""
    frame = bytes([0xFF, 0xFD, 0x94, 0x00]) + bytes(414)
    return frame * n_frames


def test_mp3_layer2_raises_where_jax_calls_libavcodec():
    """Where the JAX package's sniff hands a Layer II stream to libavcodec,
    the port no longer raises (it did before it had a Layer I / II
    decoder): it commits to the owned decoder and replays the sniffed
    bytes. The zero-payload frames decode to the JAX package's silence,
    length, rate and channels, whole and in 313-byte pushes."""
    data = _layer2_header()
    assert mp3._sniff_layer(data) == jax_mp3._sniff_layer(data) == 2
    ref = jax_mp3.Mp3Decoder()
    want = np.concatenate([ref.decode_f32(data), ref.flush_f32()])
    assert ref._av is not None  # rerouted to libavcodec
    assert want.size > 0
    for step in (len(data), 313):
        port = mp3.Mp3Decoder(device="cpu")
        got = np.concatenate([port.decode_f32(c) for c in chunks(data, step)] + [port.flush_f32()])
        np.testing.assert_array_equal(got, want)
        assert port._mpa is not None
        assert (port.sample_rate, port.channels) == (ref.sample_rate, ref.channels)


def test_mp3_av_backend_raises_and_the_env_variable_changes_nothing(monkeypatch):
    with pytest.raises(UnsupportedFormat, match="libavcodec"):
        mp3.Mp3Decoder(backend="av", device="cpu")
    data = (DATA / "mp3" / "mono8.mp3").read_bytes()
    plain = _mp3_run(mp3.Mp3Decoder(device="cpu"), data, "313")
    monkeypatch.setenv("SKT_MP3_AV", "1")
    assert jax_mp3.Mp3Decoder()._av is not None  # the JAX package reroutes
    np.testing.assert_array_equal(_mp3_run(mp3.Mp3Decoder(device="cpu"), data, "313"), plain)


# ---------------------------------------------------------------------------
# AAC-ADTS
# ---------------------------------------------------------------------------

def _aac_run(dec, data, feed):
    return np.concatenate([dec.decode_i16(p) for p in _feed(data, feed)])


@pytest.mark.parametrize("name", AAC_CLIPS)
def test_aac_adts_decoder_matches_jax(name):
    data = (DATA / name).read_bytes()
    feed = "313" if AAC_CLIPS.index(name) % 2 else "137"
    port, ref = aac.AacDecoder(), jax_aac.AacDecoder()
    got, want = _aac_run(port, data, feed), _aac_run(ref, data, feed)
    assert ref._av is None and ref._av_raw is None
    assert got.dtype == np.int16 and len(got) > 0
    np.testing.assert_array_equal(got, want)
    assert (port.sample_rate, port.channels) == (ref.sample_rate, ref.channels)


def test_aac_adts_whole_and_byte_prefix_feeds_match_jax():
    data = (DATA / "chords.aac").read_bytes()[:12000]
    for feed in ("whole", "ones"):
        np.testing.assert_array_equal(_aac_run(aac.AacDecoder(), data, feed),
                                      _aac_run(jax_aac.AacDecoder(), data, feed))


def _with_channel_config(data: bytes, chan: int) -> bytes:
    """Every ADTS header of ``data`` rewritten to channel configuration ``chan``."""
    out = bytearray()
    for frame in aac_fixtures.split_adts(data):
        f = bytearray(frame)
        f[2] = (f[2] & ~1) | (chan >> 2)
        f[3] = (f[3] & 0x3F) | ((chan & 3) << 6)
        out += f
    return bytes(out)


def _bit_concat(prefix_bits: str, payload: bytes) -> bytes:
    bits = prefix_bits + "".join(f"{b:08b}" for b in payload)
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def _with_sbr_fill(data: bytes) -> bytes:
    """The first access unit of ``data`` led by a FIL element that
    carries an SBR extension payload (count 1, type 13)."""
    frames = aac_fixtures.split_adts(data)
    first = frames[0]
    hdr = 7 if first[1] & 1 else 9
    au = _bit_concat("110" + "0001" + "1101" + "0000", first[hdr:])
    frame = bytearray(first[:hdr] + au)
    n = len(frame)
    frame[3] = (frame[3] & 0xFC) | (n >> 11)
    frame[4] = (n >> 3) & 0xFF
    frame[5] = (frame[5] & 0x1F) | ((n & 7) << 5)
    return bytes(frame) + b"".join(frames[1:])


@pytest.mark.parametrize("case", ["six_channels", "pce", "sbr"])
def test_aac_shapes_of_libavcodec_raise(case):
    data = (DATA / "drums.aac").read_bytes()[:20000]
    data = {"six_channels": lambda: _with_channel_config(data, 6),
            "pce": lambda: _with_channel_config(data, 0),
            "sbr": lambda: _with_sbr_fill(data)}[case]()
    with pytest.raises(UnsupportedFormat):
        aac.AacDecoder().decode_i16(data)
    ref = jax_aac.AacDecoder()
    ref.decode_i16(data)
    assert ref._av is not None  # the JAX package rerouted to libavcodec
    dec = aac.AacDecoder()
    with pytest.raises(UnsupportedFormat):
        dec.decode_i16(data)
    assert len(dec.decode_i16(data)) == 0  # nothing more after the refusal


def test_aac_mid_stream_failure_raises_decoding_failed():
    frames = aac_fixtures.split_adts((DATA / "speech_like.aac").read_bytes())
    good = b"".join(frames[:6])
    bad = bytearray(frames[6])
    hdr = 7 if bad[1] & 1 else 9
    bad[hdr:] = bytes([0xBF]) * (len(bad) - hdr)  # an unsupported element
    tail = b"".join(frames[7:10])
    port, ref = aac.AacDecoder(), jax_aac.AacDecoder()
    np.testing.assert_array_equal(port.decode_i16(good), ref.decode_i16(good))
    with pytest.raises(DecodingFailed, match="mid-stream"):
        port.decode_i16(bytes(bad))
    ref.decode_i16(bytes(bad))
    assert ref._av_raw is not None  # the JAX package continued on libavcodec
    assert len(port.decode_i16(tail)) == 0


def test_aac_first_unit_that_does_not_parse_raises():
    frames = aac_fixtures.split_adts((DATA / "chords.aac").read_bytes())
    bad = bytearray(frames[0])
    hdr = 7 if bad[1] & 1 else 9
    bad[hdr:] = bytes([0xBF]) * (len(bad) - hdr)
    with pytest.raises(DecodingFailed, match="first ADTS access unit"):
        aac.AacDecoder().decode_i16(bytes(bad) + b"".join(frames[1:4]))
