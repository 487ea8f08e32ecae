"""The port's container decode: M4A AAC and LOAS/LATM through the owned
raw-AU AAC-LC decoder (``codecs/aac.AacRawDecoder``), WebM Vorbis and
Opus through ``codecs/containers.WebmAdapter``, each through
``StreamDecoder`` (detection), ``DecodePipeline`` (its spawns) and
``simple.MusicDecoder``, against the JAX package on the container cases
of ``tools/container_fixtures.py``:

- M4A AAC, LATM, WebM Vorbis and WebM Opus CELT bit for bit; WebM Opus
  SILK and hybrid within 90 dB / 1 LSB (the port's SILK resampler stands
  in for libswresample), all against the JAX package's owned decoders
  on the same units (``simple.AacLcStreamDecoder``, ``WebmAdapter`` for
  Vorbis, ``codecs/opus._OpusCore`` with the same OpusHead);
- the stated departures: the JAX package decodes M4A AAC, LATM and WebM
  Opus through libavcodec; the tests record how far the port's owned
  decode lies from that, with floors just under the measured SNR."""
import numpy as np
import pytest

from soundkit_tpu.codecs import aac as jax_aac
from soundkit_tpu.codecs import containers as jax_containers
from soundkit_tpu.core.audio_types import AudioData as JaxAudioData
from soundkit_tpu.pipeline import decode_pipeline as jax_dp
from soundkit_tpu_torch import simple
from soundkit_tpu_torch.codecs import aac, containers
from soundkit_tpu_torch.core.audio_types import AudioData
from soundkit_tpu_torch.demux import latm
from soundkit_tpu_torch.pipeline import decode_pipeline as dp
from soundkit_tpu_torch.pipeline.output_options import DecodingFailed, UnsupportedFormat
from soundkit_tpu_torch.tools import container_fixtures as cf
from soundkit_tpu_torch.tools.host_codec_fixtures import mux_mp4

from torch_port_helpers import jax_container_pcm, jax_owned_aac_i16, snr_db

EXACT = cf.M4A + cf.LATM + ("webm_vorbis", "webm_opus_celt")
VOICE = ("webm_opus_silk", "webm_opus_hybrid")
INDEX = cf.load_index()


@pytest.fixture(scope="module")
def jax_pcm():
    return {n: jax_container_pcm(n) for n in cf.DECODED}


@pytest.fixture(scope="module")
def cases():
    return {n: cf.build(n) for n in cf.DECODED}


def _i16(pcm: bytes) -> np.ndarray:
    return np.frombuffer(pcm, "<i2").astype(np.int64)


def _port_core(name: str) -> dp.StreamDecoder:
    if name in cf.LATM:
        return dp.StreamDecoder(initial_decoder=aac.AacLatmAdapter(), device="cpu")
    return dp.StreamDecoder(device="cpu")


def _drive(core, data: bytes, chunk: int):
    outs = [o for i in range(0, len(data), chunk) for o in core.process(data[i:i + chunk])]
    return outs + core.process(b"")


def _pcm(outs, cls=AudioData) -> bytes:
    assert outs and all(isinstance(o, cls) for o in outs), [type(o).__name__ for o in outs]
    return b"".join(o.data for o in outs)


def _held(name: str, got: bytes, want: bytes) -> None:
    """Bit for bit, or (SILK, hybrid) within 90 dB and 1 LSB."""
    if name in VOICE:
        a, b = _i16(got), _i16(want)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1 and snr_db(a.astype(np.float64), b.astype(np.float64)) >= 90.0
    else:
        assert got == want


@pytest.mark.parametrize("chunk", [4096, 313])
@pytest.mark.parametrize("name", cf.DECODED)
def test_stream_decoder_equals_the_jax_packages_owned_decode(cases, jax_pcm, name, chunk):
    outs = _drive(_port_core(name), cases[name], chunk)
    e = INDEX[name]
    assert {(o.sampling_rate, o.channel_count, o.bits_per_sample) for o in outs} == \
        {(e["rate"], e["channels"], 16)}
    _held(name, _pcm(outs), jax_pcm[name])


@pytest.mark.parametrize("name", EXACT)
def test_decode_equals_the_index(cases, name):
    """The JAX package's decode as the index records it (what the card is
    held to) is the port's decode here."""
    pcm = _pcm(_drive(_port_core(name), cases[name], 4096))
    assert (len(pcm), cf.sha256(pcm)) == (INDEX[name]["pcm_bytes"], INDEX[name]["sha256"])


def test_silk_reference_pcm_is_the_jax_decode(jax_pcm):
    """The committed PCM of the SILK case is the JAX package's decode's
    first second, and the port lies within 1 LSB of it."""
    ref = cf.reference_pcm("webm_opus_silk")
    assert ref.size == 48000 and np.array_equal(ref, _i16(jax_pcm["webm_opus_silk"])[:48000])
    assert cf.sha256(jax_pcm["webm_opus_silk"]) == INDEX["webm_opus_silk"]["sha256"]


@pytest.mark.parametrize("name", cf.DECODED)
def test_spawns_decode_like_detection(cases, jax_pcm, name):
    """``spawn_aac_latm`` (LATM) and ``spawn_webm`` / ``spawn`` (M4A,
    WebM) in 4096-byte sends, threaded."""
    spawn = dp.DecodePipeline.spawn_aac_latm if name in cf.LATM else \
        dp.DecodePipeline.spawn_webm if name in cf.WEBM else dp.DecodePipeline.spawn
    h = spawn(device="cpu")
    data = cases[name]
    for i in range(0, len(data), 4096):
        h.send_blocking(data[i:i + 4096])
    h.send_blocking(b"")
    _held(name, _pcm(h.recv_all()), jax_pcm[name])


@pytest.mark.parametrize("fmt,name", [("m4a", "m4a_aac"), ("webm", "webm_vorbis"),
                                      ("webm", "webm_opus_celt")])
def test_music_decoder_decodes_containers(cases, jax_pcm, fmt, name):
    for dec in (simple.MusicDecoder(device="cpu"),
                simple.MusicDecoder.new_with_format(fmt, device="cpu")):
        frames = [f for i in range(0, len(cases[name]), 1000)
                  for f in dec.push(cases[name][i:i + 1000])] + dec.flush()
        assert b"".join(f.pcm for f in frames) == jax_pcm[name]
        assert {(f.sample_rate, f.channels, f.bits) for f in frames} == \
            {(INDEX[name]["rate"], INDEX[name]["channels"], 16)}


def test_detection_routes_m4a_and_webm_to_their_adapters():
    from soundkit_tpu_torch.demux.detect import AudioType

    assert isinstance(dp._init_decoder(AudioType.M4A, "cpu"), containers.M4aAdapter)
    assert isinstance(dp._init_decoder(AudioType.WEBM, "cpu"), containers.WebmAdapter)
    assert isinstance(dp._init_decoder(AudioType.ALAC, "cpu"), containers.AlacAdapter)


def test_raw_decoder_interface(cases):
    config, units = cf.units("m4a_aac")
    dec = aac.AacRawDecoder(config)
    assert (dec.sample_rate, dec.channels) == (None, None)
    pcm = np.concatenate([dec.decode_access_unit_f32(au) for au in units] + [dec.flush_f32()])
    assert pcm.dtype == np.float32 and (dec.sample_rate, dec.channels) == (48000, 2)
    assert aac.f32_to_i16(pcm).astype("<i2").tobytes() == jax_owned_aac_i16(config, units)


def _asc(object_type: int, sr_index: int = 3, channels: int = 2, tail: bytes = b"") -> bytes:
    return bytes([(object_type << 3) | (sr_index >> 1),
                  ((sr_index & 1) << 7) | (channels << 3)]) + tail


# AudioSpecificConfigs the owned decoder refuses: explicit SBR (5) and PS (29),
# AAC Main, 5.1 and 7.1 over the stereo units of m4a_aac (the element lists
# differ; the JAX package's libavcodec gives no samples for them either,
# tests/test_torch_aac_multichannel.py), a PCE (0), LC with a
# backward-compatible SBR signal
REFUSED_ASC = {"sbr": _asc(5), "ps": _asc(29), "main": _asc(1), "ch6": _asc(2, channels=6),
               "ch7": _asc(2, channels=7), "pce": _asc(2, channels=0),
               "sync_sbr": _asc(2) + bytes([0x56, 0xE5, 0x80])}


@pytest.mark.parametrize("what", REFUSED_ASC)
def test_refused_configs_raise_unsupported_format(what):
    """Through the raw decoder, an M4A with that config (at EOF) and a
    LATM stream (at its first unit): ``UnsupportedFormat`` once, no PCM."""
    asc = REFUSED_ASC[what]
    _, units = cf.units("m4a_aac")
    dec = aac.AacRawDecoder(asc)
    with pytest.raises(UnsupportedFormat, match="elements CPE" if what in ("ch6", "ch7") else None):
        dec.decode_access_unit_f32(units[0])
    assert dec.decode_access_unit_f32(units[1]).size == 0
    m4a = mux_mp4("aac", asc, units[:4], 48000, 2, 1024)
    outs = _drive(dp.StreamDecoder(device="cpu"), m4a, 4096)
    assert [type(o).__name__ for o in outs] == ["UnsupportedFormat"]
    if what not in ("ch6", "ch7"):
        # latm's ASC writer carries none of the others, and its parser
        # refuses a PCE config (no unit comes out of the demuxer)
        return
    info = latm.AscInfo(2, 3, 48000, {"ch6": 6, "ch7": 7}[what])
    loas = latm.mux_loas(units[:4], info)
    outs = _drive(dp.StreamDecoder(initial_decoder=aac.AacLatmAdapter(), device="cpu"), loas, 4096)
    # raised by a send, so the pipeline's EOF adds that no audio came
    assert [type(o).__name__ for o in outs] == ["UnsupportedFormat", "NoAudioDecoded"]


def test_he_aac_access_unit_is_refused_at_the_first_unit():
    """An LC config whose first access unit carries an SBR fill element
    (implicit HE-AAC): the first-AU gate raises ``UnsupportedFormat``."""
    config, units = cf.units("m4a_aac")
    dec = aac.AacRawDecoder(config)
    probe = aac.AacLcDecoder(3)
    probe.decode_au(units[0])
    assert not probe.sbr_seen

    class _Sbr(aac.AacLcDecoder):
        def decode_au(self, au):
            out = super().decode_au(au)
            self.sbr_seen = True
            return out

    orig = aac.AacLcDecoder
    aac.AacLcDecoder = _Sbr
    try:
        with pytest.raises(UnsupportedFormat, match="SBR"):
            dec.decode_access_unit_f32(units[0])
    finally:
        aac.AacLcDecoder = orig


def test_a_failing_unit_mid_stream_raises_decoding_failed_once(cases):
    config, units = cf.units("m4a_aac")
    bad = units[:5] + [b"\xff" * 40] + units[5:10]
    dec = aac.AacRawDecoder(config)
    for au in bad[:5]:
        assert dec.decode_access_unit_f32(au).size == 2048
    with pytest.raises(DecodingFailed, match="mid-stream"):
        dec.decode_access_unit_f32(bad[5])
    assert all(dec.decode_access_unit_f32(au).size == 0 for au in bad[6:])
    outs = _drive(dp.StreamDecoder(device="cpu"), mux_mp4("aac", config, bad, 48000, 2, 1024), 4096)
    assert [type(o).__name__ for o in outs] == ["DecodingFailed"]
    # a first unit that does not parse is a DecodingFailed too
    with pytest.raises(DecodingFailed, match="first access unit"):
        aac.AacRawDecoder(config).decode_access_unit_f32(b"\xff" * 40)


def test_latm_decoder_is_built_once_from_the_first_config():
    """A stream whose StreamMuxConfig changes mid-stream keeps the decoder
    of its first config, as the JAX package's adapter does."""
    config, units = cf.units("latm_8")
    info = cf._asc_info(config)
    mono = latm.AscInfo(2, 3, 48000, 1)
    first = latm.mux_loas(units[:10], info, 4)
    data = first + latm.mux_loas(units[10:20], mono, 4)
    # the first send ends before the changed config (the decoder is built
    # from the config the demuxer holds after the send of its first unit)
    core = dp.StreamDecoder(initial_decoder=aac.AacLatmAdapter(), device="cpu")
    outs = core.process(first) + _drive(core, data[len(first):], 4096)
    assert _pcm(outs) == jax_owned_aac_i16(config, units[:20])
    assert {o.channel_count for o in outs} == {2}


# ---------------------------------------------------------------------------
# WebM
# ---------------------------------------------------------------------------

def _opus_webm(head: bytes, packets) -> bytes:
    return cf.mux_webm("A_OPUS", head, 48000, head[9], packets, [20.0] * len(packets))


@pytest.mark.parametrize("what", ["mapping_family_1", "three_channels"])
def test_webm_multistream_opus_head_raises_unsupported_format(what):
    """A CodecPrivate the JAX package's libavcodec cannot open either
    (family 1 without its channel mapping table, family 0 with three
    channels) gives ``UnsupportedFormat`` before any audio, saying so."""
    head, packets = cf.opus_units("webm_opus_celt", 5)
    head = head[:9] + (bytes([3]) if what == "three_channels" else head[9:10]) + head[10:18] + \
        (b"\x01" if what == "mapping_family_1" else b"\x00")
    outs = _drive(dp.StreamDecoder(device="cpu"), _opus_webm(head, packets), 100000)
    assert [type(o).__name__ for o in outs] == ["UnsupportedFormat"]
    assert "libavcodec cannot open it either" in str(outs[0])
    from soundkit_tpu.codecs.avdec import AvDecodeError

    with pytest.raises(AvDecodeError):  # the JAX package's adapter does not catch it
        _drive(jax_dp.StreamDecoder(), _opus_webm(head, packets), 100000)


@pytest.mark.parametrize("chunk", [4096, 313])
def test_webm_multistream_opus_decodes(chunk):
    """A 5.1 WebM Opus track (its CodecPrivate the whole OpusHead, channel
    mapping table included) decodes through the owned multistream decoder
    by detection: six channels, the JAX package's length, within 1 LSB of
    its libavcodec decode."""
    from soundkit_tpu_torch.tools import opus_ms_fixtures

    head, packets = opus_ms_fixtures.head_and_packets("surround51")
    data = cf.mux_webm("A_OPUS", head, 48000, 6, packets, [20.0] * len(packets))
    outs = _drive(dp.StreamDecoder(device="cpu"), data, chunk)
    assert {o.channel_count for o in outs} == {6}
    got = _i16(_pcm(outs))
    want = _i16(_pcm(_drive(jax_dp.StreamDecoder(), data, chunk), JaxAudioData))
    assert got.shape == want.shape == (6 * (len(packets) * 960 - 312),)
    assert np.abs(got - want).max() <= 1


def test_webm_unknown_codec_fails_as_in_the_jax_package():
    data = cf.mux_webm("A_FLAC", b"fLaC", 44100, 2, [b"\x00" * 40] * 3, [20.0] * 3)
    got = _drive(dp.StreamDecoder(device="cpu"), data, 4096)
    core = jax_dp.StreamDecoder()
    want = core.process(data) + core.process(b"")
    assert [type(o).__name__ for o in got] == [type(o).__name__ for o in want] == \
        ["DecodingFailed"]
    assert str(got[0]) == str(want[0])


def test_webm_vorbis_adapter_equals_the_jax_packages_whole_and_bytewise(cases):
    """The verbatim route: ``WebmAdapter`` fed byte by byte and whole gives
    the JAX adapter's int16 chunks."""
    data = cases["webm_vorbis"]
    for chunk in (1, len(data)):
        port, ref = containers.WebmAdapter(), jax_containers.WebmAdapter()
        got = [a.data for i in range(0, len(data), chunk) for a in port.process(data[i:i + chunk])]
        want = [a.data for i in range(0, len(data), chunk) for a in ref.process(data[i:i + chunk])]
        assert b"".join(got + [a.data for a in port.flush()]) == \
            b"".join(want + [a.data for a in ref.flush()])


# ---------------------------------------------------------------------------
# the stated departures: the JAX package's libavcodec routes
# ---------------------------------------------------------------------------

# SNR of the port's owned decode against the JAX package's libavcodec decode of
# the same case, measured on this repository's cases: m4a_aac 37.56 dB, the LATM
# cases 25.86, WebM Opus CELT 105.98, SILK 86.19, hybrid 59.68; every floor a
# little under its reading, so that a broken decode shows
LIBAVCODEC_FLOOR_DB = {"m4a_aac": 36.0, "latm_8": 24.5, "latm_1": 24.5, "webm_opus_celt": 104.0,
                       "webm_opus_silk": 84.0, "webm_opus_hybrid": 58.0}


@pytest.mark.parametrize("name", sorted(LIBAVCODEC_FLOOR_DB))
def test_departure_from_the_jax_packages_libavcodec_route(cases, name):
    """The JAX package's M4aAdapter / AacLatmAdapter / WebmAdapter over
    libavcodec against the port: the same length, aligned at offset 0 (both
    trim the OpusHead's pre-skip of 312 samples at the start), SNR above
    the floor."""
    port = _pcm(_drive(_port_core(name), cases[name], 4096))
    core = jax_dp.StreamDecoder(initial_decoder=jax_aac.AacLatmAdapter()) if name in cf.LATM \
        else jax_dp.StreamDecoder()
    ref = _pcm(core.process(cases[name]) + core.process(b""), JaxAudioData)
    a, b = _i16(port).astype(np.float64), _i16(ref).astype(np.float64)
    assert a.shape == b.shape
    ch = INDEX[name]["channels"]
    if name.startswith("webm_opus"):
        assert a.size // ch == cf.OPUS_PACKETS * 960 - 312
    snr = snr_db(a, b)
    shifted = [snr_db(a[k * ch:], b[:b.size - k * ch]) for k in (1, 2)]
    assert snr >= LIBAVCODEC_FLOOR_DB[name] and snr > max(shifted)
