"""Port parity of the streaming Opus decoders (``codecs/opus.py`` over
``opus_core``, ``opus_celt``, ``opus_silk``, ``opus_rc``, the native CELT
and SILK parses and ``utils/silk_resampler.py``) against the JAX package's
on the CPU, fed the fixtures of ``tests/data/torch_port/opus`` in 4096-
and 313-byte chunks: CELT-only streams bit-exact (the same host code),
SILK and hybrid streams at 90 dB or better with identical sample counts
(the port's resampler rounds its float64 sums where libswresample sums in
float32). Also the fast path's replay into the Python decoder, the
trimmed-history replay, the raw framing, ``simple.OpusDeboxer`` and
``simple.OpusDecoder``, the libavcodec branches, which raise here, and a
multistream head, which decodes through the owned multistream decoder."""
import struct

import numpy as np
import pytest

from soundkit_tpu import simple as jax_simple
from soundkit_tpu.codecs import opus as jax_opus
from soundkit_tpu_torch import simple
from soundkit_tpu_torch.codecs import opus
from soundkit_tpu_torch.pipeline.output_options import DecodingFailed, UnsupportedFormat
from soundkit_tpu_torch.tools import opus_fixtures

from torch_port_helpers import ogg_opus, snr_db

CELT = opus_fixtures.CLIPS
VOICE = opus_fixtures.VOICE_CLIPS
BAR_DB = 90.0


def _clip(name: str):
    names = CELT if name in CELT else VOICE
    return opus_fixtures.load_clips(names=names)[names.index(name)]


def _decode(dec, data: bytes, chunk: int) -> np.ndarray:
    outs = [dec.decode_f32(data[i:i + chunk]) for i in range(0, len(data), chunk)]
    return np.concatenate(outs + [dec.flush()])


def _held(got: np.ndarray, want: np.ndarray, exact: bool) -> None:
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert snr_db(got, want) >= BAR_DB


@pytest.mark.parametrize("chunk", [4096, 313])
@pytest.mark.parametrize("name", CELT + VOICE)
def test_ogg_opus_decoder_matches_jax(name, chunk):
    data = _clip(name).stream()
    port, ref = opus.OggOpusDecoder(), jax_opus.OggOpusDecoder()
    got, want = _decode(port, data, chunk), _decode(ref, data, chunk)
    _held(got, want, exact=name in CELT)
    assert (port.sample_rate, port.channels) == (ref.sample_rate, ref.channels) == \
        (48000, _clip(name).channels)
    # CELT streams stay on the native fast path, voice streams replay into
    # the Python decoder at their first packet
    assert (port._core._fast is not False) == (name in CELT)


def _ten_ms(packet: bytes) -> bytes:
    return bytes([(30 << 3) | (packet[0] & 7)]) + packet[1:]  # CELT FB 10 ms


def test_fast_path_replays_into_the_python_decoder_at_a_10ms_packet():
    """A CELT stream on the native fast path meets a 10 ms packet: the
    whole history replays through the Python decoder, whose state then
    decodes on; the samples equal the JAX package's bit for bit."""
    clip = _clip("stereo96")
    packets = clip.packets[:30] + [_ten_ms(clip.packets[30])] + clip.packets[31:40]
    data = ogg_opus(clip.head, packets)
    port, ref = opus.OggOpusDecoder(), jax_opus.OggOpusDecoder()
    got, want = _decode(port, data, 4096), _decode(ref, data, 4096)
    _held(got, want, exact=True)
    assert port._core._fast is False and port._core._own is not None
    assert got.size == 2 * (39 * 960 + 480 - clip.pre_skip)


def test_trimmed_history_replay_past_the_cap():
    """Past ``_HISTORY_CAP`` packets the history keeps ``_HISTORY_KEEP``;
    a replay then converges from that tail, as in the JAX package (the
    same arithmetic, bit for bit)."""
    clip = _clip("mono64")
    packets = (clip.packets * 3)[: opus._HISTORY_CAP + 20] + [_ten_ms(clip.packets[5])] + \
        clip.packets[6:16]
    data = ogg_opus(clip.head, packets)
    port, ref = opus.OggOpusDecoder(), jax_opus.OggOpusDecoder()
    got, want = _decode(port, data, 4096), _decode(ref, data, 4096)
    _held(got, want, exact=True)
    assert port._core._dropped == ref._core._dropped > 0
    assert len(port._core._history) <= opus._HISTORY_CAP
    assert (opus._HISTORY_CAP, opus._HISTORY_KEEP) == (jax_opus._HISTORY_CAP, jax_opus._HISTORY_KEEP)


def _raw(clip, n=None) -> bytes:
    pk = clip.packets[:n]
    return clip.head + b"".join(struct.pack("<H", len(p)) + p for p in pk)


@pytest.mark.parametrize("name", ["stereo96", "silk_mb", "hybrid_swb"])
def test_opus_stream_decoder_matches_jax(name):
    data = _raw(_clip(name))
    port, ref = opus.OpusStreamDecoder(), jax_opus.OpusStreamDecoder()
    got, want = _decode(port, data, 313), _decode(ref, data, 313)
    _held(got, want, exact=name in CELT)
    np.testing.assert_array_equal(port.decode_i16(b""), ref.decode_i16(b""))


@pytest.mark.parametrize("name", ["owned", "silk_wb"])
def test_opus_deboxer_matches_jax(name):
    clip = _clip(name)
    for data in (clip.stream(), _raw(clip)):
        port, ref = simple.OpusDeboxer(), jax_simple.OpusDeboxer()
        got, want = [], []
        for i in range(0, len(data), 313):
            got += port.push(data[i:i + 313])
            want += ref.push(data[i:i + 313])
        assert got == want == clip.packets
        assert port.opus_head == ref.opus_head == clip.head
        assert port.flush() == ref.flush() == []
    with pytest.raises(ValueError, match="not an Opus stream"):
        simple.OpusDeboxer().push(b"RIFF0000WAVE")


@pytest.mark.parametrize("name", ["gain", "silk_nb", "hybrid_fb"])
def test_simple_opus_decoder_matches_jax(name):
    """``dec_frame`` and ``dec_frame_reuse``: the same int16 (CELT), within
    1 LSB (SILK and hybrid), the same counts and the reusable buffer."""
    clip = _clip(name)
    port = simple.OpusDecoder(clip.channels)
    ref = jax_simple.OpusDecoder(clip.channels)
    lsb = 0 if name in CELT else 1
    for k, pkt in enumerate(clip.packets[:12]):
        if k % 2:
            n, m = port.dec_frame_reuse(pkt), ref.dec_frame_reuse(pkt)
            assert n == m == port.decoded_size == 960
            g, w = port.output, ref.output
        else:
            r, s = port.dec_frame(pkt), ref.dec_frame(pkt)
            assert (r.decoded_size, r.channels) == (s.decoded_size, s.channels)
            g, w = r.pcm(), s.pcm()
        assert g.dtype == w.dtype == np.int16 and g.shape == w.shape
        assert np.abs(g.astype(np.int32) - w).max() <= lsb
    with pytest.raises(ValueError, match="48 kHz"):
        simple.OpusDecoder(1, 16000)


def test_multistream_head_raises_unsupported_format():
    """A head the JAX package's libavcodec cannot open either (family 1
    without its channel mapping table, family 0 with three channels) raises
    ``UnsupportedFormat`` when it parses, saying so, on both framings, and
    the pipeline reports it as data; the JAX package fails on both."""
    from soundkit_tpu.codecs.avdec import AvDecodeError
    from soundkit_tpu_torch.pipeline.decode_pipeline import StreamDecoder

    clip = _clip("stereo96")
    family1 = clip.head[:18] + b"\x01"
    three = clip.head[:9] + b"\x03" + clip.head[10:]
    for head in (family1, three):
        with pytest.raises(AvDecodeError):
            jax_opus.OggOpusDecoder().decode_f32(ogg_opus(head, clip.packets[:4]))
        with pytest.raises(UnsupportedFormat, match="libavcodec cannot open it either"):
            opus.OggOpusDecoder().decode_f32(ogg_opus(head, clip.packets[:4]))
        with pytest.raises(UnsupportedFormat, match="libavcodec cannot open it either"):
            opus.OpusStreamDecoder().decode_f32(head + struct.pack("<H", 3) + b"abc")
    outs = StreamDecoder(device="cpu").process(ogg_opus(family1, clip.packets[:4]) + bytes(9000))
    assert [type(o).__name__ for o in outs] == ["UnsupportedFormat"]
    assert "decodes through libavcodec" not in str(outs[0])


def test_a_multistream_head_decodes():
    """A 5.1 head with its channel mapping table decodes through the owned
    multistream decoder, to the JAX package's length and channel count
    (libavcodec there) and the same PCM within the CELT floor of
    ``tests/test_torch_opus_multistream.py``; the pipeline gives it as
    six-channel audio."""
    from soundkit_tpu_torch.pipeline.decode_pipeline import StreamDecoder
    from soundkit_tpu_torch.tools import opus_ms_fixtures

    head, packets = opus_ms_fixtures.head_and_packets("surround51")
    data = ogg_opus(head, packets[:12])
    port, ref = opus.OggOpusDecoder(), jax_opus.OggOpusDecoder()
    got, want = _decode(port, data, 313), _decode(ref, data, 4096)
    assert port.channels == ref.channels == 6 and got.shape == want.shape == (6 * (12 * 960 - 312),)
    assert snr_db(got, want) >= 104.0
    core = StreamDecoder(device="cpu")
    outs = core.process(data) + core.process(b"")
    assert {(type(o).__name__, o.channel_count) for o in outs} == {("AudioData", 6)}


def test_a_packet_the_owned_decoder_refuses_ends_the_stream():
    """Stereo packets in a mono stream: the JAX package replays the stream
    into libavcodec; the port raises ``DecodingFailed`` once, and the
    stream gives no more PCM."""
    mono, stereo = _clip("mono64"), _clip("stereo96")
    data = ogg_opus(mono.head, mono.packets[:6] + stereo.packets[:4])
    dec = opus.OggOpusDecoder()
    with pytest.raises(DecodingFailed, match="libavcodec"):
        dec.decode_f32(data)
    assert dec._core._own is None
    assert dec.decode_f32(ogg_opus(mono.head, mono.packets[:3])[-200:]).size == 0
    assert dec.flush().size == 0


@pytest.mark.parametrize("case", opus_fixtures.REROUTE_CASES)
def test_reroute_cases_of_the_fixture_tool_equal_the_test_helpers(case):
    """``tools/opus_fixtures.reroute_case`` (which ``chip_smoke.py`` builds
    the fleet's rerouted streams with) and its Ogg writer give the test
    side's cases byte for byte; the committed hybrid packets are libopus's."""
    from torch_port_helpers import REROUTE_CASES, hybrid_redundancy_packets, opus_reroute_case

    assert opus_fixtures.REROUTE_CASES == REROUTE_CASES
    want = opus_reroute_case(opus_fixtures.load_clips(), case)
    got = opus_fixtures.reroute_case(case)
    assert got == want
    assert opus_fixtures.ogg_stream(got[0], got[1]) == ogg_opus(want[0], want[1])
    if case == "hybrid_redundancy_start":
        assert got[1] == hybrid_redundancy_packets(4)
