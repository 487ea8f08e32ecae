"""AAC-LC beyond two channels in the port (channel configurations 3-7 in
ADTS, M4A and LOAS/LATM; ``codecs/aac_layout.py`` behind
``codecs/aac.AacDecoder`` and ``AacRawDecoder``) against the JAX package,
which decodes these streams through libavcodec, on the CPU.

The clips are ``tests/data/torch_port/aac_mc`` (``tools/aac_mc_fixtures``:
configurations 3-7, the 5.1 clip's units in an MP4 and a LOAS stream, and
the encoder's 2.1, 6.1 and 7.1-with-PCE streams). Each decodable clip is
held:

- bit for bit to the JAX package's own ``AacLcDecoder`` + ``AacLcSynth``
  on the same access units, permuted into libavcodec's channel order by
  ``aac_layout.LIBAVCODEC_ORDER`` (the same code, so the same bits and
  the same noise draws), whole and in 4096- and 313-byte chunks;
- to the JAX package's libavcodec decode: the same channel count, length
  and order, and the PNS-aware measure of
  ``tools/aac_mc_fixtures`` (perceptual noise substitution, PNS, fills
  bands with noise each decoder draws its own way): on the PNS-free
  channel-frames at least 125 dB a channel, and no channel-frame under
  the clip's measured worst less 10 dB; each PNS band's energy at the
  owned decoder's PNS scale (``pns_fault_db``) from libavcodec's.

Also the same measure on the six stereo clips and the M4A / LATM cases,
the paths that reach the decoders (``DecodePipeline``, the simple API,
MPEG-TS), the downmix, the refusals the port shares with the JAX
package's libavcodec, and ``StreamFleet``, which moves a 5.1 stream to
its host fallback where the JAX fleet decodes its centre alone."""
import functools

import numpy as np
import pytest

from soundkit_tpu.codecs import aac as jax_aac
from soundkit_tpu.pipeline import output_options as jax_oo
from soundkit_tpu_torch import simple
from soundkit_tpu_torch.codecs import aac
from soundkit_tpu_torch.codecs.aac_layout import CHANNELS, CONFIG_ELEMENTS, LIBAVCODEC_ORDER
from soundkit_tpu_torch.codecs.avdec import f32_to_i16
from soundkit_tpu_torch.core.audio_pipeline import audio_to_f32_channels
from soundkit_tpu_torch.core.audio_types import AudioData
from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder
from soundkit_tpu_torch.models.fleet import StreamFleet
from soundkit_tpu_torch.models.vorbis_batch import TopologyMismatch
from soundkit_tpu_torch.pipeline import decode_pipeline as dp
from soundkit_tpu_torch.pipeline.output_options import (
    DecodeOptions,
    DecodingFailed,
    UnsupportedFormat,
)
from soundkit_tpu_torch.tools import aac_mc_fixtures as amf
from soundkit_tpu_torch.tools import container_fixtures as cf

from torch_port_helpers import (
    aac_batched_libavcodec_snr,
    jax_libavcodec_aac,
    jax_owned_aac_planar,
    port_owned_aac_planar,
)

CLIPS = list(amf.CLIPS)
CHUNKS = [4096, 313]
# the least PNS-free channel-frame against libavcodec, measured on each clip
# (tests/data/torch_port/aac_mc/index.json, "worst_db"): cfg6's is its centre
# in frame 0, the encoder's priming frame, 43 dB under full scale
MEASURED_WORST_DB = {"cfg3": 136.64, "cfg4": 136.64, "cfg5": 136.37, "cfg6": 86.39,
                     "cfg7": 136.11}
PNS_FREE_FLOOR_DB = 125.0
# the owned decoder's PNS band energy lies at pns_fault_db (its PNS scale,
# width * 2^-50 of the specification's energy) from libavcodec's: measured
# within 0.52 dB on the multichannel clips and 0.22 on the stereo ones
# (libavcodec's float32 output), on the bands no TNS, M/S or intensity
# touches
PNS_ENERGY_BAR_DB = 1.0
# the stereo clips' PNS-free channel-frames (the port's synthesis against
# libavcodec, aac_batched_libavcodec_snr("host")): the worst measured is
# sweep_pan's 127.75 dB; aggregates 137.56-138.83 dB
STEREO_WORST_FLOOR_DB = 125.0
STEREO_AGGREGATE_FLOOR_DB = 135.0


def _units(name):
    return amf.units(name)[1]


def _planar(interleaved: np.ndarray, channels: int) -> np.ndarray:
    return interleaved.reshape(-1, channels).T.astype(np.float64)


@functools.lru_cache(maxsize=None)
def _jax_owned(name) -> np.ndarray:
    """The JAX package's own decode of a clip's units in libavcodec's
    order, interleaved float32 as ``codecs/aac``'s decoders emit it."""
    config = amf.CLIPS.get(name, 6)
    planar = jax_owned_aac_planar(_units(name))[list(LIBAVCODEC_ORDER[config])]
    return planar.T.reshape(-1).astype(np.float32)


def _adts_f32(data: bytes, chunk: int = 0) -> np.ndarray:
    dec = aac.AacDecoder()
    step = chunk or len(data)
    out = [dec.decode_f32(data[i:i + step]) for i in range(0, len(data), step)]
    return np.concatenate(out + [dec.flush_f32()])


def _drive(core, data: bytes, chunk: int):
    outs = [o for i in range(0, len(data), chunk) for o in core.process(data[i:i + chunk])]
    return outs + core.process(b"")


def _pcm(outs) -> bytes:
    assert outs and all(isinstance(o, AudioData) for o in outs), [type(o).__name__ for o in outs]
    return b"".join(o.data for o in outs)


def _i16(pcm: bytes, channels: int) -> np.ndarray:
    return np.frombuffer(pcm, "<i2").reshape(-1, channels).T


def _assert_against_libavcodec(name, got: np.ndarray, ref: np.ndarray, config: int, aus):
    """``got`` / ``ref`` [C, n]: the same shape, every channel's PNS-free
    SNR at the floor, no channel-frame under the clip's worst less 10 dB."""
    assert got.shape == ref.shape
    r = amf.pns_free_snr(got, ref, amf.pns_flags(amf.frame_channels(aus, config)))
    assert min(r["channel_frames"]) > 0, r
    assert min(r["snr_db"]) >= PNS_FREE_FLOOR_DB, r
    assert r["worst_db"] >= MEASURED_WORST_DB.get(name, MEASURED_WORST_DB["cfg6"]) - 10.0, r


# ---------------------------------------------------------------------------
# the layout table and the fixtures
# ---------------------------------------------------------------------------

def test_layout_tables():
    """Table 1.19's element lists give configuration 7 eight channels, and
    every order is a permutation that puts the centre third (the first
    SCE, bitstream channel 0) and, in 5.1 and 7.1, the LFE fourth."""
    assert [CHANNELS[c] for c in range(1, 8)] == [1, 2, 3, 4, 5, 6, 8]
    for c, order in LIBAVCODEC_ORDER.items():
        assert sorted(order) == list(range(CHANNELS[c]))
        if c >= 3:
            assert order[2] == 0
        if CONFIG_ELEMENTS[c][-1] == "LFE":
            assert order[3] == CHANNELS[c] - 1


@pytest.mark.parametrize("name", CLIPS + list(amf.REFUSED))
def test_clips_are_the_index(name):
    """Each file is the index's (SHA-256), with its configuration and the
    element list of its units; the spliced clips carry their sources'
    elements bit for bit."""
    e = amf.load_index()[name]
    data = amf.clip_bytes(name)
    assert amf.sha256(data) == e["sha256"]
    config, aus = amf.units(name)
    assert (config[1] >> 3) & 0xF == e["config"] and len(aus) == e["frames"]
    assert [k for k, _, _ in amf.element_spans(aus[1])] == e["elements"]
    if name in amf.CLIPS:
        assert tuple(e["elements"]) == CONFIG_ELEMENTS[e["config"]]
        assert e["order"] == list(LIBAVCODEC_ORDER[e["config"]])


def test_splice_keeps_each_elements_bits():
    """Splicing every element of a unit in its order gives a unit that
    decodes to the same samples; ``cfg3``'s units are the 4.0 clip's first
    two elements, bit for bit."""
    aus = _units("cfg4")
    whole = [amf.splice(au, range(3)) for au in aus[:6]]
    np.testing.assert_array_equal(port_owned_aac_planar(whole), port_owned_aac_planar(aus[:6]))

    def bits(au, spans):
        b = "".join(f"{x:08b}" for x in au)
        return [b[s:e] for _, s, e in spans]

    for src, cut in zip(aus, _units("cfg3")):
        assert bits(cut, amf.element_spans(cut)) == bits(src, amf.element_spans(src))[:2]


# ---------------------------------------------------------------------------
# the decoders against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [0] + CHUNKS)
@pytest.mark.parametrize("name", CLIPS)
def test_adts_decode_is_the_jax_packages_own_decoder_permuted(name, chunk):
    """``AacDecoder`` bit for bit the JAX package's ``AacLcDecoder`` +
    ``AacLcSynth`` permuted, float32 whole and chunked; whole, its int16,
    channels and rate, the int16 equal to ``reference_pcm.npz``."""
    want = _jax_owned(name)
    got = _adts_f32(amf.clip_bytes(name), chunk)
    np.testing.assert_array_equal(got, want)
    if chunk:
        return
    dec = aac.AacDecoder()
    pcm16 = dec.decode_i16(amf.clip_bytes(name))
    assert (dec.channels, dec.sample_rate) == (CHANNELS[amf.CLIPS[name]], 48000)
    np.testing.assert_array_equal(pcm16, f32_to_i16(want))
    np.testing.assert_array_equal(pcm16, amf.reference(name, "pcm"))


@pytest.mark.parametrize("name", CLIPS)
def test_adts_decode_against_the_jax_packages_libavcodec(name):
    """The JAX package's ``AacDecoder`` (libavcodec for these streams):
    the same channels, length and order; PNS-free SNR and the PNS band
    energies (the port's synthesis in float64, where the owned PNS bands
    lie far under float32's rounding of the rest) at their bars."""
    config = amf.CLIPS[name]
    data = amf.clip_bytes(name)
    ref = jax_libavcodec_aac(data)
    ch = CHANNELS[config]
    jax = jax_aac.AacDecoder()
    jax.decode_f32(data)
    assert jax.channels == ch
    aus = _units(name)
    _assert_against_libavcodec(name, _planar(_adts_f32(data), ch), _planar(ref, ch), config, aus)
    own = port_owned_aac_planar(aus)[list(LIBAVCODEC_ORDER[config])]
    bands = amf.pns_band_energies(own, _planar(ref, ch), amf.frame_channels(aus, config))
    s = amf.pns_energy_summary(bands)
    if name == "cfg6":  # its 16 PNS channel-frames all lie beside short windows
        assert s == {"bands": 0}
        return
    assert s["clean_bands"] > 0 and s["clean_off_fault_db_max"] <= PNS_ENERGY_BAR_DB, s


@pytest.mark.parametrize("name", CLIPS)
def test_raw_decoder_equals_the_adts_decoder(name):
    """``AacRawDecoder`` under the clip's AudioSpecificConfig gives the
    ADTS decoder's samples, channels and rate."""
    config, aus = amf.units(name)
    dec = aac.AacRawDecoder(config)
    got = np.concatenate([dec.decode_access_unit_f32(au) for au in aus] + [dec.flush_f32()])
    np.testing.assert_array_equal(got, _jax_owned(name))
    assert (dec.channels, dec.sample_rate) == (CHANNELS[amf.CLIPS[name]], 48000)


def _container(kind: str, name: str) -> bytes:
    """Clip ``name``'s units in an MP4 or a LOAS/LATM stream."""
    from soundkit_tpu_torch.demux.latm import mux_loas, parse_audio_specific_config
    from soundkit_tpu_torch.tools.host_codec_fixtures import mux_mp4

    config, aus = amf.units(name)
    info = parse_audio_specific_config(config)
    if kind == "m4a":
        return mux_mp4("aac", config, aus, 48000, CHANNELS[amf.CLIPS[name]], 1024)
    return mux_loas(aus, info)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", ["m4a", "latm"])
@pytest.mark.parametrize("name", CLIPS)
def test_m4a_and_latm_through_the_pipeline(name, kind, chunk):
    """Each clip's units in an MP4 (detected) and a LOAS stream
    (``AacLatmAdapter``, as ``spawn_aac_latm`` builds it): its channels at
    48 kHz, bit for bit the ADTS clip's int16."""
    ch = CHANNELS[amf.CLIPS[name]]
    adapter = aac.AacLatmAdapter() if kind == "latm" else None
    outs = _drive(dp.StreamDecoder(initial_decoder=adapter, device="cpu"), _container(kind, name),
                  chunk)
    assert {(o.channel_count, o.sampling_rate) for o in outs} == {(ch, 48000)}
    assert _pcm(outs) == amf.reference(name, "pcm").astype("<i2").tobytes()


@pytest.mark.parametrize("name", amf.CONTAINERS)
def test_m4a_and_latm_51_against_libavcodec(name):
    """The 5.1 cases as ``chip_smoke.py`` builds them, through
    ``DecodePipeline.spawn`` / ``spawn_aac_latm`` on their threads: the
    ADTS clip's int16; the JAX package's libavcodec decode of the same
    units (its ``AacRawDecoder``) at the PNS-free floors against the
    port's float32."""
    spawn = dp.DecodePipeline.spawn_aac_latm if name == "latm_51" else dp.DecodePipeline.spawn
    h = spawn(device="cpu")
    data = amf.build(name)
    for i in range(0, len(data), 4096):
        h.send_blocking(data[i:i + 4096])
    h.send_blocking(b"")
    assert _pcm(h.recv_all()) == amf.reference("cfg6", "pcm").astype("<i2").tobytes()
    config, aus = amf.units(name)
    ref = _planar(jax_libavcodec_aac(config=config, aus=aus), 6)
    dec = aac.AacRawDecoder(config)
    got = np.concatenate([dec.decode_access_unit_f32(au) for au in aus])
    _assert_against_libavcodec(name, _planar(got, 6), ref, 6, aus)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", CLIPS)
def test_decode_pipeline_spawn(name, chunk):
    """``StreamDecoder`` detects each ADTS clip and gives the decoder's
    int16 in its channels, chunked as given; ``DecodePipeline.spawn`` on
    its thread gives the same."""
    ch = CHANNELS[amf.CLIPS[name]]
    data = amf.clip_bytes(name)
    outs = _drive(dp.StreamDecoder(device="cpu"), data, chunk)
    assert {o.channel_count for o in outs} == {ch}
    want = amf.reference(name, "pcm").astype("<i2").tobytes()
    assert _pcm(outs) == want
    if chunk == CHUNKS[0]:
        h = dp.DecodePipeline.spawn(device="cpu")
        for i in range(0, len(data), chunk):
            h.send_blocking(data[i:i + chunk])
        h.send_blocking(b"")
        assert _pcm(h.recv_all()) == want


@pytest.mark.parametrize("name", CLIPS)
def test_simple_api_and_mpeg_ts(name):
    """``MusicDecoder`` on the ADTS and M4A bytes gives the decoder's
    int16; ``AacDeboxer`` writes the configuration into its
    AudioSpecificConfig, and ``AacLcStreamDecoder`` (the JAX package's
    WASM mirror, copied verbatim) decodes its units in bitstream order, as
    the JAX package's does; an MPEG-TS ADTS track of the clip's frames
    joins back to the clip's bytes."""
    from soundkit_tpu import simple as jax_simple

    config = amf.CLIPS[name]
    data, want = amf.clip_bytes(name), amf.reference(name, "pcm")
    for fmt, stream in (("aac", data), ("m4a", _container("m4a", name))):
        md = simple.MusicDecoder.new_with_format(fmt, device="cpu")
        frames = md.push(stream) + md.flush()
        assert {f.channels for f in frames} == {CHANNELS[config]}
        got = np.concatenate([np.frombuffer(f.pcm, "<i2") for f in frames])
        np.testing.assert_array_equal(got, want)
    box = simple.AacDeboxer()
    aus = [au for i in range(0, len(data), 313) for au in box.push(data[i:i + 313])]
    assert box.audio_specific_config == amf.asc(config)
    mine = simple.AacLcStreamDecoder(box.audio_specific_config)
    ref = jax_simple.AacLcStreamDecoder(box.audio_specific_config)
    planar = np.concatenate([mine.decode_planar(au) for au in aus], axis=1)
    np.testing.assert_array_equal(planar, np.concatenate([ref.decode_planar(au) for au in aus],
                                                         axis=1))
    order = list(LIBAVCODEC_ORDER[config])
    np.testing.assert_array_equal(planar[order].T.reshape(-1).astype(np.float32), _jax_owned(name))
    ts = cf.mux_ts([(0x0F, 0x101, cf._pes_groups(_adts_frames(name), 4, 1920))])
    events = cf.demux_events(simple.AudioTrackDemuxer(), ts, 188)
    joined = b"".join(p.data for p in events[1:])
    assert events[0].codec.value == "aac" and joined == data


def _adts_frames(name):
    from soundkit_tpu_torch.tools.aac_fixtures import split_adts

    return split_adts(amf.clip_bytes(name))


@pytest.mark.parametrize("target", [2, 1])
def test_downmix_reads_libavcodecs_order(target):
    """``output_channels`` 2 and 1 on the 5.1 clip: each output the JAX
    package's ``downmix_channels`` of the port's own 6-channel output of
    the same send (L R C LFE Ls Rs, so the centre goes to both sides)."""
    data = amf.clip_bytes("cfg6")
    six = _drive(dp.StreamDecoder(device="cpu"), data, 4096)
    mixed = _drive(dp.StreamDecoder(DecodeOptions(output_channels=target), device="cpu"), data,
                   4096)
    assert len(six) == len(mixed)
    for a, b in zip(six, mixed):
        chans = jax_oo.downmix_channels(audio_to_f32_channels(a), target)
        assert b.channel_count == target
        assert b.data == jax_oo.f32_channels_to_bytes(chans, 16, b.audio_format)


# ---------------------------------------------------------------------------
# refusals shared with the JAX package's libavcodec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", amf.REFUSED)
def test_encoder_streams_outside_the_specification_are_refused(name):
    """The encoder's 2.1 (CPE LFE under configuration 3), 6.1 (CPE SCE
    SCE CPE SCE under 7) and 7.1-with-PCE (configuration 0) streams:
    ``UnsupportedFormat`` at the first unit, nothing after; the JAX
    package's libavcodec gives no samples for any of them."""
    data = amf.clip_bytes(name)
    dec = aac.AacDecoder()
    match = "program config element" if name == "enc_71_pce" else "elements .* carries"
    with pytest.raises(UnsupportedFormat, match=match):
        dec.decode_f32(data[:4096])
    assert dec.decode_f32(data[4096:]).size == 0
    assert jax_libavcodec_aac(data).size == 0


@pytest.mark.parametrize("config", [3, 6, 7])
def test_stereo_units_under_a_multichannel_config_are_refused(config):
    """Stereo units under a 3-, 6- or 7-configuration ASC (raw, M4A,
    LATM) or ADTS header: ``UnsupportedFormat`` naming the elements; the
    JAX package's libavcodec gives no samples."""
    _, aus = cf.aac_units("chords", 6)
    asc = amf.asc(config)
    dec = aac.AacRawDecoder(asc)
    with pytest.raises(UnsupportedFormat, match="elements CPE in an access unit"):
        dec.decode_access_unit_f32(aus[0])
    assert dec.decode_access_unit_f32(aus[1]).size == 0
    assert jax_libavcodec_aac(config=asc, aus=aus).size == 0
    with pytest.raises(UnsupportedFormat, match="elements CPE"):
        aac.AacDecoder().decode_f32(amf.adts(aus, config))
    assert jax_libavcodec_aac(amf.adts(aus, config)).size == 0


def test_a_unit_of_other_elements_mid_stream_fails_once():
    """A 5.1 stream whose fifth unit is a stereo one: the first four units
    decode, then ``DecodingFailed`` once, then nothing; a first unit with a
    coupling channel element (element 2, which the parser refuses) fails
    as a unit that does not parse."""
    aus = _units("cfg6")
    stereo = cf.aac_units("chords", 1)[1]
    dec = aac.AacDecoder()
    head = dec.decode_f32(amf.adts(aus[:4], 6))
    np.testing.assert_array_equal(head, _jax_owned("cfg6")[:4 * 1024 * 6])
    with pytest.raises(DecodingFailed, match="mid-stream.*elements CPE"):
        dec.decode_f32(amf.adts(stereo, 6))
    assert dec.decode_f32(amf.adts(aus[5:8], 6)).size == 0
    cce = bytes([0x40]) + aus[0]  # 010: a CCE element id leads the unit
    with pytest.raises(DecodingFailed, match="first ADTS access unit"):
        aac.AacDecoder().decode_f32(amf.adts([cce] + aus[1:3], 6))


def test_pce_config_stays_refused():
    """A configuration-0 AudioSpecificConfig (a PCE) keeps its refusal."""
    with pytest.raises(UnsupportedFormat, match="program config element"):
        aac.AacRawDecoder(amf.asc(0)).decode_access_unit_f32(_units("cfg6")[0])


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def test_batched_model_refuses_a_lane_beyond_stereo():
    """``BatchedAacLcDecoder.push`` raises ``TopologyMismatch`` at the push
    that completes a 5.1 lane's first frame, queues nothing and leaves the
    lane unconfigured; the reset lane then takes a stereo stream."""
    model = BatchedAacLcDecoder(2, 2, device="cpu")
    data = amf.clip_bytes("cfg6")
    first = len(_adts_frames("cfg6")[0])
    model.push(0, data[:first - 1])
    assert not model.lane_configured(0)
    with pytest.raises(TopologyMismatch, match="channel configuration 6"):
        model.push(0, data[first - 1:first + 10])
    assert model.lane_ready(0) == 0 and not model.lane_configured(0)
    model.reset_lane(0)
    model.push(0, b"".join(cf.adts_frames("chords", 3)))
    assert model.lane_configured(0) and model.lane_ready(0) == 3


def _port_stream(data: bytes) -> np.ndarray:
    """The port's ``StreamDecoder`` output of ``data`` as the fleet's host
    fallback returns it: [C, n] float32 from its int16."""
    outs = _drive(dp.StreamDecoder(device="cpu"), data, len(data))
    return np.concatenate([np.stack(audio_to_f32_channels(o)) for o in outs], axis=1)


def _collect_all(fleet, sids) -> dict:
    got = {}
    for _ in range(3):
        for sid, pcm in fleet.collect().items():
            got.setdefault(sid, []).append(pcm)
    return {sid: np.concatenate(got[sid], axis=1) for sid in sids}


def test_fleet_moves_51_streams_to_the_host_fallback():
    """A detected 5.1 ADTS stream, one of the explicit kind ``aac`` and a
    5.1 M4A stream come out of the port's fleet as six channels from the
    host fallback, equal to the port's ``StreamDecoder``; the ADTS streams
    were seated in an AAC lane first and left it at the push that
    completed their first frame, the lane freed. The JAX fleet gives the
    detected stream as a stereo lane: its centre alone, the second
    channel silent (the departure), against the centre of the JAX
    package's ``StreamDecoder`` (libavcodec) decode."""
    from soundkit_tpu.models.fleet import StreamFleet as JaxFleet
    from soundkit_tpu.pipeline import decode_pipeline as jax_dp

    data, m4a = amf.clip_bytes("cfg6"), amf.build("m4a_51")
    port = StreamFleet(2, device="cpu")
    port.push("a", data[:9000])  # detected, its first frame whole: seated, then moved
    assert "a" in port._fallback and "a" not in port._lanes and "a" not in port._pretopo
    port.push("a", data[9000:])
    port.push("b", data[:100], kind="aac")
    assert "b" in port._lanes and "b" in port._pretopo  # seated, the first frame incomplete
    port.push("b", data[100:])
    assert "b" in port._fallback and "b" not in port._lanes and "b" not in port._pretopo
    port.push("c", m4a)
    for sid in "abc":
        port.end_stream(sid)
    got = _collect_all(port, "abc")
    want = _port_stream(data)
    assert want.shape == (6, 48 * 1024)
    for sid in "ab":
        np.testing.assert_array_equal(got[sid], want)
    np.testing.assert_array_equal(got["c"], _port_stream(m4a))
    assert sorted(port._groups["aac"]._free) == [0, 1]

    ref = JaxFleet(2)
    ref.push("a", data)
    ref.end_stream("a")
    lane = _collect_all(ref, "a")["a"]
    assert lane.shape[0] == 2 and not lane[1].any()
    outs = _drive(jax_dp.StreamDecoder(), data, len(data))
    centre = np.concatenate([np.frombuffer(o.data, "<i2").reshape(-1, 6)[:, 2] for o in outs])
    n = min(lane.shape[1], centre.size)
    c = np.corrcoef(lane[0, :n], centre[:n] / 32768.0)[0, 1]
    assert c > 0.999, c


# ---------------------------------------------------------------------------
# the PNS-aware measure on the stereo clips
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stereo_readings():
    return aac_batched_libavcodec_snr("host")


@pytest.mark.parametrize("name", ["noise_pad", "castanets", "drums", "sweep_pan"])
def test_pns_free_snr_of_the_stereo_clips(stereo_readings, name):
    """The stereo clips with PNS-free channel-frames: each channel's
    aggregate at 135 dB and every channel-frame at 125 dB (the measured
    worst is sweep_pan's 127.75 dB)."""
    r = stereo_readings[name]["pns_free"]
    assert min(r["channel_frames"]) > 0
    assert min(r["snr_db"]) >= STEREO_AGGREGATE_FLOOR_DB, r
    assert r["worst_db"] >= STEREO_WORST_FLOOR_DB, r


@pytest.mark.parametrize("name", ["noise_pad", "castanets", "chords", "speech_like", "drums",
                                  "sweep_pan", "m4a_aac", "latm_8"])
def test_pns_band_energy_of_the_stereo_clips(stereo_readings, name):
    """Every stereo clip and container case (``chords``, ``speech_like``
    and both cases have a PNS band in every frame, so this is their only
    figure): the owned decoder's PNS bands lie at its PNS scale from
    libavcodec's, within the bar, on the bands no TNS, M/S or intensity
    touches; the rest within 140 dB under libavcodec's."""
    s = stereo_readings[name]["pns_energy"]
    assert s["clean_bands"] > 0 and s["clean_off_fault_db_max"] <= PNS_ENERGY_BAR_DB, s
    assert s["db_min"] >= -140.0, s
