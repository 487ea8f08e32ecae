"""Multistream Opus in the port (``codecs/opus_multistream.py`` behind
``codecs/opus.open_opus_core``) against the JAX package, which decodes
these streams through libavcodec, and against libopus's
``opus_multistream_decode_float``, on the CPU.

The clips are ``tests/data/torch_port/opus_ms`` (5.1 and 7.1 by libopus's
surround encoder, three channels at 20 / 40 / 60 ms with VBR on and off,
first-order ambisonics, a family-255 VoIP stream of a hybrid and a SILK
stream with a silent and a copied output, 5.1 with a pre-skip of 1500 and
an output gain). Each is held:

- bit for bit to the port's own single-stream decode of each elementary
  stream's split packets, mapped in libavcodec's channel order;
- to the JAX package's decode of the same Ogg and WebM bytes: the same
  length and channel count, and floors a stream kind;
- to libopus, floors a stream kind (where ``libopus.so.0`` is found).

Also the channel mapping heads each package opens and refuses, the
multistream packet's four TOC codes, chunked pushes, ``DecodePipeline``
with and without a downmix, and the two stated departures from
libavcodec, where the port gives libopus's answer."""
import struct

import numpy as np
import pytest

from soundkit_tpu.codecs import opus as jax_opus
from soundkit_tpu.codecs.avdec import AvDecodeError
from soundkit_tpu.pipeline import decode_pipeline as jax_dp
from soundkit_tpu.pipeline.output_options import DecodeOptions as JaxDecodeOptions
from soundkit_tpu_torch.codecs import opus
from soundkit_tpu_torch.codecs.avdec import f32_to_i16
from soundkit_tpu_torch.codecs.opus_multistream import (
    _MultistreamCore,
    packet_samples,
    parse_channel_mapping,
    split_multistream_packet,
)
from soundkit_tpu_torch.pipeline import decode_pipeline as dp
from soundkit_tpu_torch.pipeline.output_options import (
    DecodeOptions,
    DecodingFailed,
    UnsupportedFormat,
)
from soundkit_tpu_torch.tools import container_fixtures as cf
from soundkit_tpu_torch.tools import opus_ms_fixtures as mf

from torch_port_helpers import (
    LIBAVCODEC_ORDER,
    jax_ogg_opus_f32,
    libopus,
    libopus_ms_decode,
    libopus_ms_reference,
    opus_ms_sources,
    opus_ms_stream_kinds,
    snr_db,
)

CLIPS = mf.CLIPS
# dB floors against the JAX package's libavcodec decode, a stream kind
# (torch_port_helpers.opus_ms_readings): CELT reads 132.25-136.32 and SILK
# 128.45 (the floors of tests/test_torch_opus_host_models.py); hybrid reads
# 36.61 / 37.36 (voip255's coupled stream), 49.44 and 88.24 (the ambisonic
# clip's two hybrid streams) and 105.26 (surround51_gain's third stream).
# The low hybrid readings are the owned hybrid decoder's departure from
# libavcodec's on a few packets (the coupled stream's first two read 20 and
# 32 dB, every later one 123-134 dB), the same elementary packets through
# the JAX package's own decoder read >= 140 dB (below).
JAX_FLOOR_DB = {"celt": 104.0, "silk": 84.0, "hybrid": 35.0}
# dB floors against libopus: CELT mono streams read 133.19-136.16, coupled
# CELT streams 42.52-55.74 (libavcodec's stereo CELT, which the owned
# decoder follows, lies as far from libopus on single-stream stereo clips:
# 43.7 dB on surround51's first stream, 56.7 on stereo96), SILK 10.87 and
# hybrid 11.52-17.6 (libopus resamples SILK with its own filter, libavcodec
# and the port with libswresample's)
LIBOPUS_FLOOR_DB = {"celt": 130.0, "celt_coupled": 40.0, "silk": 10.0, "hybrid": 10.0}
OWNED_FLOOR_DB = 140.0
needs_libopus = pytest.mark.skipif(libopus() is None, reason="libopus.so.0 is not on this machine")


def _decode(data: bytes, chunk: int = 0) -> np.ndarray:
    dec = opus.OggOpusDecoder()
    chunk = chunk or len(data)
    outs = [dec.decode_f32(data[i:i + chunk]) for i in range(0, len(data), chunk)]
    return np.concatenate(outs + [dec.flush()]).reshape(-1, dec.channels)


def _elementary(head: bytes, packets, core_cls=opus._OpusCore, head_cls=opus.OpusHead):
    """Each stream's split packets decoded alone (a family-0 head of the
    stream's channels, no pre-skip or gain), lined up from their first
    samples and mapped to the output channels,
    the gain applied in float32 (a second time to a copied channel, as
    libavcodec does) and the pre-skip taken off."""
    ch, n_streams, coupled = head[9], head[19], head[20]
    pre_skip, gain = struct.unpack_from("<Hxxxxh", head, 10)
    parts = [split_multistream_packet(p, n_streams) for p in packets]
    streams = []
    for s in range(n_streams):
        c = 2 if s < coupled else 1
        core = core_cls(head_cls.parse(b"OpusHead" + bytes([1, c]) +
                                       struct.pack("<HIhB", 0, 48000, 0, 0)))
        streams.append(np.concatenate([core.decode_packet_f32(q[s]) for q in parts]).reshape(-1, c))
    # streams of different delays line up from their first samples; what
    # one has beyond the others at the end stays unplayed
    n = min(len(x) for x in streams)
    out = np.zeros((n, ch), np.float32)
    seen = set()
    g = np.float32(10.0 ** (gain / (20.0 * 256.0)))
    for k, (s, c) in enumerate(opus_ms_sources(head)):
        if s < 0:
            continue
        out[:, k] = streams[s][:n, c]
        if gain:
            out[:, k] *= g
            if (s, c) in seen:
                out[:, k] *= g
        seen.add((s, c))
    return out[pre_skip:]


def _webm(head: bytes, packets) -> bytes:
    return cf.mux_webm("A_OPUS", head, 48000, head[9], packets,
                       [packet_samples(p) / 48.0 for p in packets])


def _webm_i16(data: bytes, channels: int, port: bool) -> np.ndarray:
    from soundkit_tpu.codecs.containers import WebmAdapter as JaxWebm
    from soundkit_tpu_torch.codecs.containers import WebmAdapter

    ad = WebmAdapter() if port else JaxWebm()
    outs = ad.process(data) + ad.flush()
    assert {o.channel_count for o in outs} == {channels}
    return np.frombuffer(b"".join(o.data for o in outs), "<i2")


# ---------------------------------------------------------------------------
# the fixtures
# ---------------------------------------------------------------------------

def test_fixtures_equal_a_regeneration(tmp_path):
    """The generator (libopus's multistream encoders through ctypes and the
    JAX package's libavcodec decode) makes the committed clips, index and
    reference PCM byte for byte."""
    from torch_port_helpers import generate_opus_ms_fixtures

    if libopus() is None:
        pytest.skip("libopus.so.0 is not on this machine")
    generate_opus_ms_fixtures(tmp_path)
    names = sorted(p.name for p in mf.FIXTURE_DIR.iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == names
    for name in names:
        if name.endswith(".npz"):
            with np.load(tmp_path / name) as got, np.load(mf.FIXTURE_DIR / name) as want:
                assert sorted(got.files) == sorted(want.files) == sorted(CLIPS)
                for k in want.files:
                    np.testing.assert_array_equal(got[k], want[k])
            continue
        assert (tmp_path / name).read_bytes() == (mf.FIXTURE_DIR / name).read_bytes(), name


def test_index_describes_the_clips():
    """Heads, hashes and coverage: the three-channel clip's self-delimited
    stream uses all four TOC codes and its last stream padded code 3; the
    VoIP clip's streams are hybrid and SILK; the 5.1 and 7.1 clips carry
    their LFE stream; the new fixture data stays under 2 MB."""
    index = mf.load_index()
    assert tuple(index) == CLIPS
    total = 0
    for name, e in index.items():
        data = mf.clip_bytes(name)
        total += len(data)
        head, packets = mf.head_and_packets(name)
        assert mf.sha256(data) == e["sha256"] and [len(p) for p in packets] == e["packets"]
        assert (head[9], head[18], head[19], head[20], list(head[21:])) == \
            (e["channels"], e["family"], e["streams"], e["coupled"], e["table"])
        assert struct.unpack_from("<Hxxxxh", head, 10) == (e["pre_skip"], e["output_gain"])
        assert mf.reference_pcm(name).size == (
            e["frames"] * e["channels"] if name == mf.SMOKE else mf.REFERENCE_FRAMES * e["channels"])
    total += (mf.FIXTURE_DIR / "reference_pcm.npz").stat().st_size
    assert total < 2_000_000
    assert index["three_40ms"]["stream_codes"] == [[0, 1, 2, 3], [0, 1, 2, 3, "padded"]]
    assert opus_ms_stream_kinds(*mf.head_and_packets("voip255")) == \
        [None, "hybrid", "hybrid", "silk", "silk"]
    assert index["surround51"]["table"] == [0, 4, 1, 2, 3, 5]  # LFE: the last mono stream
    assert index["surround71"]["table"] == [0, 6, 1, 2, 3, 4, 5, 7]


# ---------------------------------------------------------------------------
# the decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CLIPS)
def test_each_channel_is_its_elementary_stream_bit_for_bit(name):
    head, packets = mf.head_and_packets(name)
    got = _decode(mf.clip_bytes(name))
    np.testing.assert_array_equal(got, _elementary(head, packets))


@pytest.mark.parametrize("container", ["ogg", "webm"])
@pytest.mark.parametrize("name", CLIPS)
def test_matches_the_jax_package(name, container):
    """The same length and channel count as the JAX package's libavcodec
    decode, each channel at its stream kind's floor; in WebM, each
    package's int16 PCM is its Ogg decode's. The hybrid streams are also
    held to the JAX package's own single-stream decoder, mapped alike."""
    head, packets = mf.head_and_packets(name)
    data = mf.clip_bytes(name)
    got = _decode(data)
    want, channels = jax_ogg_opus_f32(data)
    want = want.reshape(-1, channels)
    assert got.shape == want.shape == (mf.load_index()[name]["frames"], head[9])
    kinds = opus_ms_stream_kinds(head, packets)
    for k, kind in enumerate(kinds):
        if kind is None:
            assert not got[:, k].any() and not want[:, k].any()
        else:
            assert snr_db(got[:, k], want[:, k]) >= JAX_FLOOR_DB[kind], (k, kind)
    if "hybrid" in kinds:
        owned = _elementary(head, packets, jax_opus._OpusCore, jax_opus.OpusHead)
        assert snr_db(got, owned) >= OWNED_FLOOR_DB
    if container == "webm":
        webm = _webm(head, packets)
        np.testing.assert_array_equal(_webm_i16(webm, head[9], port=True),
                                      f32_to_i16(got.reshape(-1)))
        np.testing.assert_array_equal(_webm_i16(webm, head[9], port=False),
                                      f32_to_i16(want.reshape(-1)))


@needs_libopus
@pytest.mark.parametrize("name", CLIPS)
def test_matches_libopus(name):
    """libopus's ``opus_multistream_decode_float``, permuted to libavcodec's
    order, pre-skip and gain applied: each channel at its floor (coupled
    CELT streams apart, see ``LIBOPUS_FLOOR_DB``)."""
    head, packets = mf.head_and_packets(name)
    got = _decode(mf.clip_bytes(name))
    ref = libopus_ms_reference(head, packets)
    assert len(ref) >= len(got)
    for k, (kind, (s, _c)) in enumerate(zip(opus_ms_stream_kinds(head, packets),
                                             opus_ms_sources(head))):
        if kind is None:
            continue
        key = "celt_coupled" if kind == "celt" and s < head[20] else kind
        assert snr_db(got[:, k], ref[:len(got), k]) >= LIBOPUS_FLOOR_DB[key], (k, key)


def _tone_of(x: np.ndarray) -> int:
    """The frequency in Hz of a channel's strongest component over 0.1 s."""
    seg = x[4800:9600].astype(np.float64)
    return int(np.argmax(np.abs(np.fft.rfft(seg))) * 10)


@pytest.mark.parametrize("name", ["three_40ms", "surround51", "surround71"])
def test_family_1_comes_out_in_libavcodec_channel_order(name):
    """Output channel k carries the tone of Vorbis-order input channel
    ``LIBAVCODEC_ORDER[channels][k]`` in both packages: the LFE (the last
    input channel of 5.1 and 7.1) at output 3."""
    data = mf.clip_bytes(name)
    ch = mf.load_index()[name]["channels"]
    tones = [mf.LFE_TONE if ch in (6, 8) and i == ch - 1 else mf.TONES[i] for i in range(ch)]
    want = [tones[i] for i in LIBAVCODEC_ORDER[ch]]
    jax_pcm = jax_ogg_opus_f32(data)[0].reshape(-1, ch)
    for pcm in (_decode(data), jax_pcm):
        assert [_tone_of(pcm[:, k]) for k in range(ch)] == want
    if ch in (6, 8):
        assert want[3] == mf.LFE_TONE


@pytest.mark.parametrize("name", ["surround51", "three_40ms", "voip255"])
def test_chunked_pushes_give_the_whole_stream(name):
    data = mf.clip_bytes(name)
    np.testing.assert_array_equal(_decode(data, 313), _decode(data))


@pytest.mark.parametrize("downmix", [None, 2])
@pytest.mark.parametrize("spawn", ["spawn", "spawn_ogg_opus"])
def test_decode_pipeline_serves_the_5_1_stream(spawn, downmix):
    """``DecodePipeline.spawn`` (by detection) and ``spawn_ogg_opus``, with
    and without a downmix to two channels: the port's int16 output is its
    Ogg decode's without a downmix, and within 1 LSB of the JAX package's
    pipeline either way (``output_options.downmix_channels`` folds the
    six channels into two)."""
    data = mf.clip_bytes("surround51")
    h = getattr(dp.DecodePipeline, spawn)(DecodeOptions(output_channels=downmix), device="cpu") \
        if spawn == "spawn_ogg_opus" else \
        dp.DecodePipeline.spawn_with_options(DecodeOptions(output_channels=downmix), device="cpu")
    for i in range(0, len(data), 4096):
        h.send_blocking(data[i:i + 4096])
    h.send_blocking(b"")
    outs = h.recv_all()
    assert outs and {o.channel_count for o in outs} == {downmix or 6}
    got = np.frombuffer(b"".join(o.data for o in outs), "<i2")
    core = jax_dp.StreamDecoder(JaxDecodeOptions(output_channels=downmix))
    ref = [o for i in range(0, len(data), 4096) for o in core.process(data[i:i + 4096])]
    ref = np.frombuffer(b"".join(o.data for o in ref + core.process(b"")), "<i2")
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.int32) - ref).max() <= 1
    if not downmix:
        np.testing.assert_array_equal(got, f32_to_i16(_decode(data).reshape(-1)))


# ---------------------------------------------------------------------------
# the heads
# ---------------------------------------------------------------------------

def _ms_head(ch, family, n, m, table, version=1) -> bytes:
    return (b"OpusHead" + bytes([version, ch]) + struct.pack("<HIhB", 312, 48000, 0, family)
            + bytes([n, m]) + bytes(table))


OPENED = {
    "family1_stereo": _ms_head(2, 1, 1, 1, [0, 1]),
    "family1_mono": _ms_head(1, 1, 1, 0, [0]),
    "family1_3": _ms_head(3, 1, 2, 1, [0, 2, 1]),
    "family1_4": _ms_head(4, 1, 2, 2, [0, 1, 2, 3]),
    "family1_6": _ms_head(6, 1, 4, 2, [0, 4, 1, 2, 3, 5]),
    "family1_8": _ms_head(8, 1, 5, 3, [0, 6, 1, 2, 3, 4, 5, 7]),
    "family2_4": _ms_head(4, 2, 4, 0, [0, 1, 2, 3]),
    "family2_6_nondiegetic": _ms_head(6, 2, 5, 1, [2, 3, 4, 5, 0, 1]),
    "family2_9": _ms_head(9, 2, 9, 0, list(range(9))),
    "family255_silence_and_copy": _ms_head(5, 255, 2, 1, [255, 0, 1, 2, 2]),
    "family255_one_mono": _ms_head(3, 255, 1, 0, [0, 255, 0]),
    "trailing_bytes": _ms_head(2, 1, 1, 1, [0, 1]) + b"\x00\x01",
}
REFUSED = {
    "family1_no_table": b"OpusHead" + bytes([1, 6]) + struct.pack("<HIhB", 312, 48000, 0, 1),
    "family1_short_table": _ms_head(6, 1, 4, 2, [0, 4, 1, 2, 3]),
    "family0_three_channels": b"OpusHead" + bytes([1, 3]) + struct.pack("<HIhB", 312, 48000, 0, 0),
    "family3": _ms_head(4, 3, 2, 2, [0, 1, 2, 3]),
    "family1_nine_channels": _ms_head(9, 1, 9, 0, list(range(9))),
    "family2_five_channels": _ms_head(5, 2, 5, 0, [0, 1, 2, 3, 4]),
    "entry_past_the_streams": _ms_head(3, 255, 2, 1, [0, 1, 3]),
    "no_streams": _ms_head(2, 255, 0, 0, [255, 255]),
    "more_coupled_than_streams": _ms_head(2, 1, 1, 2, [0, 1]),
    "version_16": _ms_head(2, 1, 1, 1, [0, 1], version=16),
    "zero_channels": _ms_head(0, 255, 1, 0, []),
}


@pytest.mark.parametrize("case", OPENED)
def test_heads_the_jax_package_opens(case):
    """The heads the JAX package's libavcodec opens parse to their streams
    and channels, and the port's Ogg decoder builds a multistream core."""
    from soundkit_tpu.codecs.avdec import AvDecoder

    head = OPENED[case]
    AvDecoder("opus", extradata=head)  # opens
    m = parse_channel_mapping(opus.OpusHead.parse(head))
    assert (m.streams, m.coupled, m.channels) == (head[19], head[20], head[9])
    assert [m.source(k) for k in range(m.channels)] == opus_ms_sources(head)
    dec = opus.OggOpusDecoder()
    dec.decode_f32(mf.ogg_stream(head, []))
    assert isinstance(dec._core, _MultistreamCore) and dec.channels == head[9]


@pytest.mark.parametrize("case", REFUSED)
def test_heads_neither_package_opens(case):
    """The JAX package fails to open each of these heads (``AvDecodeError``);
    the port raises ``UnsupportedFormat`` saying so, through the Ogg and
    WebM decoders and the pipeline, and names no libavcodec decode."""
    head = REFUSED[case]
    packets = mf.head_and_packets("surround51")[1][:2]
    with pytest.raises(AvDecodeError):
        jax_opus.OggOpusDecoder().decode_f32(mf.ogg_stream(head, packets))
    with pytest.raises(UnsupportedFormat, match="libavcodec cannot open it either") as e:
        opus.OggOpusDecoder().decode_f32(mf.ogg_stream(head, packets))
    assert "decodes through" not in str(e.value)
    core = dp.StreamDecoder(device="cpu")
    outs = core.process(_webm(head, packets)) + core.process(b"")
    assert [type(o).__name__ for o in outs] == ["UnsupportedFormat"]


def test_the_raw_framing_refuses_every_multistream_head():
    """Soundkit's raw framing reads a 19-byte head, which never holds a
    channel mapping table: a multistream head is refused, as the JAX
    package's libavcodec refuses it."""
    for head in (OPENED["family1_6"], OPENED["family255_silence_and_copy"]):
        raw = head[:19] + struct.pack("<H", 3) + b"abc"
        with pytest.raises(AvDecodeError):
            jax_opus.OpusStreamDecoder().decode_f32(raw)
        with pytest.raises(UnsupportedFormat, match="no whole channel mapping table"):
            opus.OpusStreamDecoder().decode_f32(raw)


# ---------------------------------------------------------------------------
# the packet
# ---------------------------------------------------------------------------

def _size(n: int) -> bytes:
    return bytes([n]) if n < 252 else bytes([252 + (n - 252) % 4, (n - 252 - (n - 252) % 4) // 4])


def _reframe(packet: bytes, form: str, self_delimited: bool) -> bytes:
    """``packet`` (an ordinary one) rewritten in ``form`` ('same': its own
    code; 'code3_vbr_padded', 'code3_cbr_padded': code 3, VBR or CBR, with
    300 bytes of padding), self-delimited or not."""
    from soundkit_tpu_torch.codecs.opus_core import parse_packet

    toc, frames = parse_packet(packet)
    t = packet[0] & 0xFC
    code = packet[0] & 3
    if form != "same":
        cbr = form == "code3_cbr_padded"
        if cbr and len({len(f) for f in frames}) > 1:
            cbr = False
        head = bytes([t | 3, (0 if cbr else 0x80) | 0x40 | len(frames), 255, 46])
        lens = b"" if cbr else b"".join(_size(len(f)) for f in frames[:-1])
        sd = _size(len(frames[-1])) if self_delimited else b""
        return head + lens + sd + b"".join(frames) + bytes(300)
    if not self_delimited:
        return packet
    if code == 0:
        return packet[:1] + _size(len(frames[0])) + frames[0]
    if code == 1:
        return packet[:1] + _size(len(frames[0])) + b"".join(frames)
    if code == 2:
        return packet[:1] + _size(len(frames[0])) + _size(len(frames[1])) + b"".join(frames)
    raise AssertionError("reframe code 3 through its form")


@pytest.mark.parametrize("form", ["same", "code3_vbr_padded", "code3_cbr_padded"])
def test_every_toc_code_splits_back(form):
    """The three-channel clip's packets rebuilt with each stream in
    ``form`` (its own code 0-3, or code 3 with 300 bytes of padding, VBR
    or CBR, self-delimited in the first stream): the split gives back
    packets of the same frames, the decode is the clip's bit for bit, and
    libopus decodes the rebuilt packets as it decodes the clip's."""
    from soundkit_tpu_torch.codecs.opus_core import parse_packet

    head, packets = mf.head_and_packets("three_40ms")
    rebuilt = []
    for p in packets:
        a, b = split_multistream_packet(p, 2)
        if form == "same" and a[0] & 3 == 3:
            rebuilt.append(p)
            continue
        rebuilt.append(_reframe(a, form, True) + _reframe(b, form, False))
    for p, q in zip(packets, rebuilt):
        for x, y in zip(split_multistream_packet(p, 2), split_multistream_packet(q, 2)):
            assert parse_packet(x)[1] == parse_packet(y)[1]
    np.testing.assert_array_equal(_decode(mf.ogg_stream(head, rebuilt)),
                                  _decode(mf.clip_bytes("three_40ms")))
    if libopus() is not None:
        np.testing.assert_array_equal(libopus_ms_decode(head, rebuilt),
                                      libopus_ms_decode(head, packets))


def test_packets_that_do_not_split_are_refused():
    """A packet that runs past its end, or whose streams disagree in
    duration, raises ``DecodingFailed``, once; the stream gives no more
    PCM, and libopus refuses the same packets."""
    head, packets = mf.head_and_packets("surround51")
    a, *rest = split_multistream_packet(packets[3], 4)
    longer = bytes([a[0] & 0xFC | 1]) + _size(len(a) - 1) + a[1:] + a[1:]  # two frames: 40 ms
    bad = {
        "truncated": packets[3][:40],
        "durations_disagree": longer + b"".join(
            _reframe(q, "same", True) for q in rest[:-1]) + rest[-1],
        "empty": b"",
    }
    for case, p in bad.items():
        with pytest.raises(DecodingFailed, match="multistream Opus packet"):
            split_multistream_packet(p, 4)
        core = opus.open_opus_core(opus.OpusHead.parse(head))
        core.decode_packet_f32(packets[0])
        with pytest.raises(DecodingFailed):
            core.decode_packet_f32(p)
        assert core.decode_packet_f32(packets[1]).size == 0, case
        if libopus() is not None and p:
            with pytest.raises(AssertionError):
                libopus_ms_decode(head, [p])


def test_a_frame_of_no_bytes_is_refused():
    """A stream whose frame has no bytes (a lost or DTX frame) is concealed
    by libavcodec (the JAX package's channels there are neither silent nor
    the coded audio); the owned decoder has no such concealment and raises
    ``DecodingFailed`` rather than fill silence."""
    head, packets = mf.head_and_packets("surround51")
    parts = split_multistream_packet(packets[10], 4)
    lost = _reframe(parts[0][:1], "same", True) + b"".join(
        _reframe(q, "same", True) for q in parts[1:-1]) + parts[-1]
    stream = packets[:10] + [lost] + packets[11:14]
    want = jax_ogg_opus_f32(mf.ogg_stream(head, stream))[0].reshape(-1, 6)
    seg = want[10 * 960 - 312: 11 * 960 - 312]
    assert np.abs(seg[:, 0]).max() > 0.01 and np.abs(seg[:, 2]).max() > 0.01
    with pytest.raises(DecodingFailed, match="frame of no bytes"):
        _decode(mf.ogg_stream(head, stream))


# ---------------------------------------------------------------------------
# libavcodec's output gain on a copy, and the stated departures
# ---------------------------------------------------------------------------

def test_a_copied_channel_takes_the_gain_twice_as_in_libavcodec():
    """libavcodec copies a duplicated table entry's channel after scaling
    it and then scales the copy again; the port does the same."""
    head, packets = mf.head_and_packets("voip255")
    gained = head[:16] + struct.pack("<h", -1536) + head[18:]
    data = mf.ogg_stream(gained, packets)
    got = _decode(data)
    want = jax_ogg_opus_f32(data)[0].reshape(-1, 5)
    np.testing.assert_array_equal(got, _elementary(gained, packets))
    g = np.float32(10.0 ** (-1536 / 5120.0))
    np.testing.assert_array_equal(got[:, 4], got[:, 3] * g)
    np.testing.assert_array_equal(want[:, 4], want[:, 3] * g)


@needs_libopus
def test_a_silent_entry_after_stream_0_keeps_its_channel_departure():
    """libavcodec points stream 0's first channel at a later silent entry's
    buffer too, and leaves the output channel of that stream channel with
    what its buffer held; the port gives it the stream channel, as libopus
    does (5.1's CELT packets under a family-255 head of seven channels,
    the last silent)."""
    head, packets = mf.head_and_packets("surround51")
    h255 = _ms_head(7, 255, 4, 2, [0, 1, 2, 3, 4, 5, 255])
    data = mf.ogg_stream(h255, packets)
    got = _decode(data)
    want = jax_ogg_opus_f32(data)[0].reshape(-1, 7)
    ref = libopus_ms_reference(h255, packets)[:len(got)]
    np.testing.assert_array_equal(got, _elementary(h255, packets))
    assert snr_db(got[:, 0], ref[:, 0]) >= LIBOPUS_FLOOR_DB["celt_coupled"]
    assert snr_db(want[:, 0], ref[:, 0]) < 10.0
    for k in range(1, 6):
        assert snr_db(got[:, k], want[:, k]) >= JAX_FLOOR_DB["celt"]
    assert not got[:, 6].any() and not want[:, 6].any()


@needs_libopus
def test_streams_of_different_delays_stay_aligned_departure():
    """A family-255 stream of a CELT stereo stream beside a SILK NB one (by
    libopus at run time): the SILK stream's first packet is 24 samples
    short. The port holds the CELT stream's extra samples for the next
    packet; libavcodec hands them out there but drops as many new ones, so
    its CELT channels run 24 samples early from the third packet on. The
    port's CELT channels are libopus's at lag 0; the SILK channel is the
    JAX package's."""
    from torch_port_helpers import OPUS_MS_CLIPS, libopus_ms_packets, opus_ms_head

    OPUS_MS_CLIPS.setdefault("mixed255", (3, 255, (2, 1, (0, 1, 2)), 2048, 64000, 0.3, (960,),
                                          (1,), None, 0, ((1002, 1105), (1000, 1101))))
    packets, layout, lookahead = libopus_ms_packets("mixed255")
    head = opus_ms_head(3, 255, lookahead, 0, layout)
    assert opus_ms_stream_kinds(head, packets) == ["celt", "celt", "silk"]
    data = mf.ogg_stream(head, packets)
    got = _decode(data)
    want = jax_ogg_opus_f32(data)[0].reshape(-1, 3)
    ref = libopus_ms_reference(head, packets)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, _elementary(head, packets))
    assert snr_db(got[:, 2], want[:, 2]) >= JAX_FLOOR_DB["silk"]
    first = 2 * 960 - 24 - lookahead  # the first two packets' output
    assert snr_db(got[:first, :2], want[:first, :2]) >= JAX_FLOOR_DB["celt"]
    assert snr_db(got[first + 24:, :2], want[first:-24, :2]) >= JAX_FLOOR_DB["celt"]
    assert snr_db(got[:, :2], ref[:len(got), :2]) >= LIBOPUS_FLOOR_DB["celt_coupled"]
