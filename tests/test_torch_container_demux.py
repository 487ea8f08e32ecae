"""The port's container demuxers (``demux/ebml.py``, ``mpegts.py``,
``latm.py``, ``audio_demux.py``) and ``simple.AudioTrackDemuxer`` against
the JAX package's, event for event, on the container cases of
``tools/container_fixtures.py`` (MP4, WebM, three-track MPEG-TS) at every
chunk size, and against the events that the fixtures' index records."""
import dataclasses

import numpy as np
import pytest

from soundkit_tpu.demux import audio_demux as jax_audio_demux
from soundkit_tpu.demux import ebml as jax_ebml
from soundkit_tpu.demux import latm as jax_latm
from soundkit_tpu.demux import mpegts as jax_mpegts
from soundkit_tpu import simple as jax_simple
from soundkit_tpu_torch import simple
from soundkit_tpu_torch.demux import audio_demux, ebml, latm, mpegts
from soundkit_tpu_torch.tools import container_fixtures as cf

from torch_port_helpers import jax_track_events

DEMUXED = tuple(n for n in cf.CASES if n not in cf.LATM)
CHUNKS = (1, 188, 400, 4096, 0)  # 0: the whole case in one push


@pytest.fixture(scope="module")
def cases():
    return {n: cf.build(n) for n in cf.CASES}


def _same_events(got, want):
    """Field for field: the same classes, the same values (enums by value:
    the two packages' enums are distinct classes)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert cf.event_records([g]) == cf.event_records([w])
        assert [f.name for f in dataclasses.fields(g)] == [f.name for f in dataclasses.fields(w)]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", DEMUXED)
def test_track_demuxer_events_equal_the_jax_packages(cases, name, chunk):
    data = cases[name]
    got = cf.demux_events(simple.AudioTrackDemuxer.new_auto(), data, chunk)
    want = jax_track_events(data, chunk)
    _same_events(got, want)
    assert cf.events_digest(got) == cf.load_index()[name]["events"]


@pytest.mark.parametrize("name", DEMUXED)
def test_track_demuxer_with_format_equals_the_jax_packages(cases, name):
    fmt = {"m": "mp4", "w": "webm", "t": "mpeg-ts"}[name[0]]
    got = cf.demux_events(simple.AudioTrackDemuxer.new_with_format(fmt), cases[name], 4096)
    want = cf.demux_events(jax_simple.AudioTrackDemuxer.new_with_format(fmt), cases[name], 4096)
    _same_events(got, want)
    assert cf.events_digest(got) == cf.load_index()[name]["events"]


@pytest.mark.parametrize("fmt", ["ogg", "wma", "MP4"])
def test_new_with_format_refuses_what_the_jax_package_refuses(fmt):
    with pytest.raises(audio_demux.AudioDemuxError, match="unknown container format"):
        simple.AudioTrackDemuxer.new_with_format(fmt)
    with pytest.raises(jax_audio_demux.AudioDemuxError, match="unknown container format"):
        jax_simple.AudioTrackDemuxer.new_with_format(fmt)


def test_undetectable_bytes_raise_as_in_the_jax_package():
    data = bytes(range(256)) * 300  # past the 64 KiB window
    for dm, err in ((simple.AudioTrackDemuxer(), audio_demux.AudioDemuxError),
                    (jax_simple.AudioTrackDemuxer(), jax_audio_demux.AudioDemuxError)):
        with pytest.raises(err, match="failed to detect"):
            dm.push(data)
    for dm, err in ((simple.AudioTrackDemuxer(), audio_demux.AudioDemuxError),
                    (jax_simple.AudioTrackDemuxer(), jax_audio_demux.AudioDemuxError)):
        assert dm.push(b"\x00" * 100) == []
        with pytest.raises(err, match="failed to detect"):
            dm.flush()


def test_ts_tracks_come_back_whole(cases):
    """The ADTS and MP3 tracks' packets are their PES payloads, which join
    to the elementary stream; the LATM track's are its access units, with
    the AudioSpecificConfig of the StreamMuxConfig."""
    tracks = cf.ts_tracks()
    for name in ("ts_adts", "ts_mp3"):
        events = cf.demux_events(simple.AudioTrackDemuxer(), cases[name], 188)
        cfg, packets = events[0], events[1:]
        st, pid, pes = tracks[name]
        assert (cfg.stream_type, cfg.pid) == (st, pid)
        assert b"".join(p.data for p in packets) == b"".join(d for d, _ in pes)
        assert [p.start_time for p in packets] == [pts for _, pts in pes]
    events = cf.demux_events(simple.AudioTrackDemuxer(), cases["ts_latm"], 188)
    cfg, packets = events[0], events[1:]
    asc, aus = cf.aac_units("drums", cf.TS_UNITS)
    assert cfg.packet_format == audio_demux.AudioPacketFormat.LATM
    assert cfg.codec_private == asc and (cfg.sample_rate, cfg.channels) == (48000, 2)
    assert [p.data for p in packets] == aus
    assert all(p.format == audio_demux.AudioPacketFormat.RAW for p in packets)


@pytest.mark.parametrize("size", [5000, 70000])
def test_latm_track_that_never_syncs_passes_through(size):
    """A 0x11 track whose payload holds no AudioMuxElement: held, then
    passed through as the reference does (at flush for a short stream,
    once 64 KiB are pending for a long one)."""
    rng = np.random.default_rng(23)
    junk = rng.integers(0, 256, size, dtype=np.uint8)
    junk[junk == 0x56] = 0x57  # no LOAS syncword
    junk = junk.tobytes()
    pes = [(junk[i:i + 3000], 9000 + i) for i in range(0, len(junk), 3000)]
    data = cf.mux_ts([(0x11, 0x102, pes)])
    for chunk in (188, 0):
        got = cf.demux_events(simple.AudioTrackDemuxer(), data, chunk)
        want = jax_track_events(data, chunk)
        _same_events(got, want)
        assert got[0].packet_format == audio_demux.AudioPacketFormat.LATM
        assert got[0].sample_rate is None
        assert b"".join(p.data for p in got[1:]) == junk
        assert all(p.format == audio_demux.AudioPacketFormat.LATM for p in got[1:])


def test_loas_config_again_mid_stream():
    """A StreamMuxConfig that comes again, and then a changed one: the
    demuxer keeps the last (as the JAX package's does), every unit out."""
    asc, aus = cf.aac_units("chords", 12)
    info = latm.parse_audio_specific_config(asc)
    mono = dataclasses.replace(info, channel_config=1)
    data = latm.mux_loas(aus[:6], info, config_period=3) + latm.mux_loas(aus[6:], mono, 4)
    for mod in (latm, jax_latm):
        d = mod.LoasDemuxer()
        got = [au for i in range(0, len(data), 97) for au in d.push(data[i:i + 97])]
        assert got == aus and d.frames == 12 and d.config.asc.channel_config == 1


def test_ebml_vint_and_webm_track_equal_the_jax_packages(cases):
    for data in (b"\x81", b"\x40\x02", b"\x1f\xff\xff\xff", b"\x01" + bytes(7), b"\x00"):
        assert ebml.read_vint(data, 0) == jax_ebml.read_vint(data, 0)
    for name in cf.WEBM:
        port, ref = ebml.WebmAudioDemuxer(), jax_ebml.WebmAudioDemuxer()
        got, want = port.push(cases[name]), ref.push(cases[name])
        assert got == want and len(got) == len(cf.units(name)[1])
        assert dataclasses.astuple(port.track) == dataclasses.astuple(ref.track)


def test_mpegts_demuxer_equals_the_jax_packages(cases):
    for name in cf.TS:
        port, ref = mpegts.MpegTsAudioDemuxer(), jax_mpegts.MpegTsAudioDemuxer()
        got = [p for i in range(0, len(cases[name]), 1000) for p in port.push(cases[name][i:i + 1000])]
        want = [p for i in range(0, len(cases[name]), 1000) for p in ref.push(cases[name][i:i + 1000])]
        got, want = got + port.flush(), want + ref.flush()
        assert [dataclasses.astuple(p) for p in got] == [dataclasses.astuple(p) for p in want]
        assert dataclasses.astuple(port.track) == dataclasses.astuple(ref.track)


def test_case_bytes_equal_the_index(cases):
    """The cases build to the bytes the index was made from."""
    index = cf.load_index()
    assert set(index) == set(cf.CASES)
    for name, data in cases.items():
        assert (len(data), cf.sha256(data)) == (index[name]["bytes"], index[name]["sha256_bytes"])
