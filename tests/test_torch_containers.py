"""Port parity of the container pieces on the CPU: the CAF and MP4
demuxers, the owned ALAC decoder and the EOF-buffered ALAC / M4A
adapters against the JAX package, bit for bit and equal to the source
PCM (ALAC is lossless), ``simple.AacDeboxer``'s M4A walk, and the long
streams ``chip_smoke.py`` builds from the clips. An MP4 AAC track decodes
through the owned raw-AU AAC-LC decoder (libavcodec in the JAX package);
what that decoder refuses raises, as does an MP4 track of another codec."""
import numpy as np
import pytest

from soundkit_tpu import simple as jax_simple
from soundkit_tpu.codecs import alac as jax_alac
from soundkit_tpu.codecs import containers as jax_containers
from soundkit_tpu.demux import caf as jax_caf
from soundkit_tpu.demux import mp4 as jax_mp4
from soundkit_tpu_torch import simple
from soundkit_tpu_torch.codecs import alac, containers
from soundkit_tpu_torch.demux import caf, mp4
from soundkit_tpu_torch.pipeline import decode_pipeline as dp
from soundkit_tpu_torch.pipeline.output_options import DecodingFailed, UnsupportedFormat
from soundkit_tpu_torch.tools import aac_fixtures
from soundkit_tpu_torch.tools import host_codec_fixtures as hcf

from torch_port_helpers import jax_host_decode

INDEX = hcf.load_index()


def _track_fields(t):
    return (t.codec, t.config, t.sample_rate, t.channels,
            list(getattr(t, "samples", None) or getattr(t, "packets")))


def test_caf_demux_matches_jax():
    data = hcf.clip_bytes("alac_caf")
    got, want = caf.demux_caf_audio(data), jax_caf.demux_caf_audio(data)
    assert vars(got) == vars(want)
    assert got.codec == "alac" and len(got.packets) == 3 and len(got.config) == 36
    with pytest.raises(caf.CafError):
        caf.demux_caf_audio(b"caff" + bytes(20))


def test_caf_mux_writes_what_the_jax_package_writes():
    t = caf.demux_caf_audio(hcf.clip_bytes("alac_caf"))
    args = (t.packets, t.config, t.sample_rate, t.channels, t.bits_per_channel, 4096)
    assert caf.mux_caf_alac(*args) == jax_caf.mux_caf_alac(*args)
    assert caf._normalise_alac_cookie(t.config[12:]) == jax_caf._normalise_alac_cookie(t.config[12:])


def test_mp4_demux_matches_jax():
    data = hcf.clip_bytes("alac_mp4")
    got, want = mp4.demux_mp4_audio(data), jax_mp4.demux_mp4_audio(data)
    assert _track_fields(got) == _track_fields(want)
    assert got.codec == "alac" and got.config == caf.demux_caf_audio(
        hcf.clip_bytes("alac_caf")).config
    for bad in (b"\x00\x00\x00\x10ftypM4A " + bytes(4), hcf.clip_bytes("alac_mp4")[:200]):
        with pytest.raises(mp4.Mp4Error):
            mp4.demux_mp4_audio(bad)
        with pytest.raises(jax_mp4.Mp4Error):
            jax_mp4.demux_mp4_audio(bad)


@pytest.mark.parametrize("name", hcf.ALAC)
def test_alac_packet_decoder_matches_jax_and_the_source(name):
    """Packet by packet, int32 and int16, equal to the JAX package's
    decoder; the int16 PCM is the source's (lossless)."""
    data = hcf.clip_bytes(name)
    t = caf.demux_caf_audio(data) if name == "alac_caf" else mp4.demux_mp4_audio(data)
    packets = t.packets if name == "alac_caf" else t.samples
    port, ref = alac.AlacPacketDecoder(t.config), jax_alac.AlacPacketDecoder(t.config)
    assert (port.channels, port.sample_rate, port.bits_per_sample, port.frame_length) == \
        (ref.channels, ref.sample_rate, ref.bits_per_sample, ref.frame_length) == (2, 44100, 24, 4096)
    for p in packets:
        np.testing.assert_array_equal(port.decode_packet(p), ref.decode_packet(p))
    pcm = alac.AlacPacketDecoder(t.config).decode_packets_i16(packets)
    np.testing.assert_array_equal(pcm, jax_alac.AlacPacketDecoder(t.config).decode_packets_i16(packets))
    assert hcf.sha256(pcm.astype("<i2").tobytes()) == INDEX[name]["source_sha256"]
    with pytest.raises(alac.AlacError):
        alac.AlacPacketDecoder(b"\x00" * 8)


@pytest.mark.parametrize("adapter", ["AlacAdapter", "M4aAdapter"])
@pytest.mark.parametrize("name", hcf.ALAC)
def test_alac_adapters_match_jax(adapter, name):
    """The EOF-buffered adapters in 313-byte pushes (``M4aAdapter`` takes
    MP4 only), their AudioData equal to the JAX package's."""
    if adapter == "M4aAdapter" and name == "alac_caf":
        a = containers.M4aAdapter()
        a.process(hcf.clip_bytes(name))
        with pytest.raises(DecodingFailed, match="no moov box"):
            a.flush()
        return
    data = hcf.clip_bytes(name)
    port, ref = getattr(containers, adapter)(), getattr(jax_containers, adapter)()
    got, want = [], []
    for i in range(0, len(data), 313):
        got += port.process(data[i:i + 313])
        want += ref.process(data[i:i + 313])
    got, want = got + port.flush(), want + ref.flush()
    assert got and [(o.sampling_rate, o.channel_count, o.bits_per_sample, o.data) for o in got] == \
        [(o.sampling_rate, o.channel_count, o.bits_per_sample, o.data) for o in want]
    assert hcf.sha256(got[0].data) == INDEX[name]["source_sha256"]


def _aac_m4a() -> bytes:
    """An M4A of an in-repo AAC clip: its ADTS frames' payloads as the
    samples of an ``mp4a`` track, the ASC built from its ADTS header."""
    from soundkit_tpu_torch.codecs.aac_lc import AdtsStream

    adts = AdtsStream()
    aus = adts.push((aac_fixtures.FIXTURE_DIR / "chords.aac").read_bytes())[:40]
    sr, ch = adts.sr_index, adts.channel_config
    asc = bytes([(2 << 3) | (sr >> 1), ((sr & 1) << 7) | (ch << 3)])
    return hcf.mux_mp4("aac", asc, aus, 48000, ch, 1024)


def test_aac_deboxer_walks_an_m4a_like_the_jax_package():
    """``simple.AacDeboxer``'s M4A path: the same AUs and ASC as the JAX
    package's, in 777-byte pushes; the AUs decode through the port's
    AAC-LC decoder."""
    data = _aac_m4a()
    port, ref = simple.AacDeboxer(), jax_simple.AacDeboxer()
    got, want = [], []
    for i in range(0, len(data), 777):
        got += port.push(data[i:i + 777])
        want += ref.push(data[i:i + 777])
    assert got == want == []
    got, want = got + port.flush(), want + ref.flush()
    assert got == want and len(got) == 40
    assert port.audio_specific_config == ref.audio_specific_config
    dec = simple.AacLcStreamDecoder(port.audio_specific_config)
    assert dec.sample_rate == 48000 and np.abs(dec.decode_planar(got[5])).max() > 0


def test_an_mp4_aac_track_raises_unsupported_format():
    """A stated departure: the JAX package decodes an MP4 AAC track
    through libavcodec (``codecs/containers.py:63``); the port decodes an
    AAC-LC track with its owned raw-AU decoder (equal to the JAX package's
    owned decode of the same access units, ``tests/test_torch_container_decode.py``)
    and raises ``UnsupportedFormat`` for a track that decoder refuses (an
    HE-AAC config) and for an ``mp4a`` track without an AAC config; a
    detected M4A decodes."""
    from torch_port_helpers import jax_owned_aac_i16

    data = _aac_m4a()
    track = mp4.demux_mp4_audio(data)
    want = jax_owned_aac_i16(track.config, track.samples)
    a = containers.M4aAdapter()
    assert a.process(data) == []
    assert b"".join(o.data for o in a.flush()) == want
    b = containers.AlacAdapter()
    b.process(data)
    with pytest.raises(DecodingFailed, match="expected alac track, found aac"):
        b.flush()
    core = dp.StreamDecoder(device="cpu")
    outs = core.process(data) + core.process(b"")
    assert b"".join(o.data for o in outs) == want
    he = hcf.mux_mp4("aac", bytes([0x29, 0x90]), track.samples[:4], 48000, 2, 1024)
    c = containers.M4aAdapter()
    c.process(he)
    with pytest.raises(UnsupportedFormat, match="HE-AAC"):
        c.flush()
    no_config = data.replace(b"esds", b"xsds")
    assert mp4.demux_mp4_audio(no_config).codec == "mp4a"
    d = containers.M4aAdapter()
    d.process(no_config)
    with pytest.raises(UnsupportedFormat, match="mp4a track.*libavcodec"):
        d.flush()


@pytest.mark.parametrize("spawn", ["spawn_webm", "spawn_aac_latm"])
def test_webm_and_latm_spawns_raise(spawn):
    """The two spawns decode now (``tests/test_torch_container_decode.py``);
    what still raises through them is what the owned decoders refuse: an
    OpusHead in WebM that the JAX package's libavcodec cannot open either
    (family 1 without its channel mapping table) and a 5.1 StreamMuxConfig
    in LATM over stereo units (the element lists differ; libavcodec gives
    no samples for it either; 5.1 units in LATM decode,
    ``tests/test_torch_aac_multichannel.py``), each an
    ``UnsupportedFormat`` output before any audio."""
    from soundkit_tpu_torch.demux import latm
    from soundkit_tpu_torch.tools import container_fixtures as cf

    if spawn == "spawn_webm":
        head, packets = cf.opus_units("webm_opus_celt", 4)
        data = cf.mux_webm("A_OPUS", head[:18] + b"\x01", 48000, 2, packets, [20.0] * 4)
    else:
        _asc, aus = cf.aac_units("chords", 4)
        data = latm.mux_loas(aus, latm.AscInfo(2, 3, 48000, 6))
    h = getattr(dp.DecodePipeline, spawn)(device="cpu")
    h.send_blocking(data)
    h.send_blocking(b"")
    outs = h.recv_all()
    assert type(outs[0]).__name__ == "UnsupportedFormat"
    assert spawn == "spawn_webm" or "elements CPE" in str(outs[0])
    assert not any(hasattr(o, "data") for o in outs)


@pytest.mark.parametrize("name", ["gsm_wav49", "ac3_stereo", "speex_uwb", "alac_caf", "alac_mp4",
                                  "aifc_ulaw"])
def test_long_streams_begin_with_the_clips_decode(name):
    """``long_stream`` (the smoke's streams, here three clips long): its
    container parses, its decode is three clips long and begins with the
    clip's decode as the index records it (AC-3 and Speex: as the
    committed PCM)."""
    e = INDEX[name]
    data, seconds = hcf.long_stream(name, 2.5 * e["seconds"])
    reps = round(seconds / e["seconds"])
    assert reps == 3
    outs = jax_host_decode(name, data, e["spawn"])
    pcm = b"".join(o.data for o in outs)
    assert len(pcm) == reps * e["pcm_bytes"]
    assert hcf.sha256(pcm[:e["pcm_bytes"]]) == e["sha256"]
    if name in hcf.REFERENCE_PCM:
        np.testing.assert_array_equal(np.frombuffer(pcm[:e["pcm_bytes"]], "<i2"),
                                      hcf.reference_pcm(name))
