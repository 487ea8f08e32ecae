"""The committed AAC, FLAC, MP3, Ogg Opus and Ogg Vorbis fixtures
(tests/data/torch_port) and the port's standalone host parser."""
import numpy as np

from soundkit_tpu.codecs.aac_lc_native import (
    NativeAacParser,
    _v4_views,
    prepare_frame_batch_grouped,
    prepare_v4_batch_packed,
)
from soundkit_tpu_torch.native import AacHostParser
from soundkit_tpu_torch.tools.aac_fixtures import CLIPS, lane_streams, load_clips

from soundkit_tpu_torch.tools import flac_fixtures, mp3_fixtures, opus_fixtures, vorbis_fixtures
from torch_port_helpers import (
    SR_INDEX_48K,
    clip_aus,
    generate_aac_fixtures,
    generate_flac_fixtures,
    generate_mp3_fixtures,
    generate_opus_fixtures,
    generate_vorbis_fixtures,
    host_parser,
    picked_aus,
)


def test_fixture_aus_are_v4_clean_and_cover_the_decode_paths():
    """Every AU alone fits the v4 wire, and the pool carries EIGHT_SHORT
    frames, M/S, intensity, PNS bands and TNS filters."""
    parser = host_parser()
    totals = dict(short=0, ms=0, intensity=0, pns=0, tns=0)
    for name, aus in zip(CLIPS, clip_aus()):
        assert len(aus) >= 172, name  # 1024 / 6 distinct start offsets
        for au in aus:
            assert not prepare_v4_batch_packed(parser, [au])[2], name
        buf, _, overflow = prepare_v4_batch_packed(parser, aus)
        assert not overflow
        v = _v4_views(buf, len(aus))
        B = len(aus)
        assert v["chan_valid"].reshape(B, 2).all(), name  # stereo
        totals["short"] += int((v["seq"].reshape(B, 2)[:, 0] == 2).sum())
        totals["ms"] += int((v["msis_ms"].reshape(B, -1) != 0).any(1).sum())
        totals["intensity"] += int((v["msis_sign"].reshape(B, -1) != 0).any(1).sum())
        totals["pns"] += int((((v["pns"] >> 12) & 1023) > 0).sum())
        reg = v["regions"].reshape(B, 2, 8, 3)
        totals["tns"] += int(((v["order"].reshape(B, 2, 8) > 0) & (reg[..., 1] > reg[..., 0])).sum())
    assert totals["short"] >= 20 and totals["ms"] >= 100 and totals["intensity"] >= 10
    assert totals["pns"] >= 100 and totals["tns"] >= 3, totals


def test_host_parser_matches_native_parser():
    """The standalone parser build gives the JAX package's parser's
    v4 wire byte for byte, and the same full wire. Both parsers are
    fresh: a full-wire parse advances a parser's PNS noise state."""
    aus = picked_aus()
    ours, theirs = AacHostParser(SR_INDEX_48K), NativeAacParser(SR_INDEX_48K)
    a, _, _ = prepare_v4_batch_packed(ours, aus)
    b, _, _ = prepare_v4_batch_packed(theirs, aus)
    np.testing.assert_array_equal(a, b)
    lane_sr = [SR_INDEX_48K] * len(aus)
    fa = prepare_frame_batch_grouped({SR_INDEX_48K: ours}, lane_sr, aus)
    fb = prepare_frame_batch_grouped({SR_INDEX_48K: theirs}, lane_sr, aus)
    for field in ("quant", "scale", "ms_mask", "int_factor", "perm", "filt_id", "lpc",
                  "seq", "shape", "chan_valid"):
        np.testing.assert_array_equal(getattr(fa, field), getattr(fb, field), err_msg=field)


def test_fixtures_equal_a_regeneration(tmp_path):
    """The generator (on the test side, with the JAX package's
    libavcodec-backed encoder) makes the committed clips byte for byte."""
    generate_aac_fixtures(tmp_path)
    assert load_clips(tmp_path) == load_clips()


def test_smoke_lanes_are_distinct_streams():
    lanes = lane_streams(load_clips(), 1024, 2)
    assert len(set(lanes)) == 1024


def test_flac_fixtures_equal_a_regeneration(tmp_path):
    """The generator (on the test side, with the JAX package's owned FLAC
    encoder) makes the committed streams and their frame index byte for
    byte."""
    generate_flac_fixtures(tmp_path)
    for name in (*(f"{c}.flac" for c in flac_fixtures.CLIPS), "index.json"):
        assert (tmp_path / name).read_bytes() == (flac_fixtures.FIXTURE_DIR / name).read_bytes(), name


def test_mp3_fixtures_equal_a_regeneration(tmp_path):
    """The generator (on the test side, with the JAX package's
    libmp3lame-backed encoder) makes the committed streams and their
    frame index byte for byte."""
    generate_mp3_fixtures(tmp_path)
    for name in (*(f"{c}.mp3" for c in mp3_fixtures.CLIPS), "index.json"):
        assert (tmp_path / name).read_bytes() == (mp3_fixtures.FIXTURE_DIR / name).read_bytes(), name


def test_mp3_fixtures_cover_the_decode_paths():
    """Parsed by the JAX package's pure-Python decoder: MPEG-1, MPEG-2
    and MPEG-2.5 headers, mono and stereo, M/S and L/R frames of joint
    stereo, and block types 0-3 (LAME sets no mixed blocks)."""
    from soundkit_tpu.codecs.mp3_native import Mp3NativeDecoder

    versions, modes, types, mixed = set(), set(), set(), set()
    for clip in mp3_fixtures.load_clips():
        frames = Mp3NativeDecoder().push(clip.stream())
        assert len(frames) == len(clip.frames) == len(clip.granules), clip.name
        for f in frames:
            assert f.header.sample_rate == clip.rate and f.header.nb_channels == clip.channels
            assert len(f.granules) == clip.granules[0]
            versions.add(f.header.version)
            modes.add((f.header.mode, f.header.mode_ext))
            for gr in f.granules:
                types |= {g.block_type for g in gr}
                mixed |= {bool(g.switch_point) for g in gr}
    assert versions == {3, 2, 0} and types == {0, 1, 2, 3} and mixed == {False}
    assert {(1, 2), (1, 0), (3, 0)} <= modes


def test_opus_fixtures_equal_a_regeneration(tmp_path):
    """The generator (on the test side, with the JAX package's libopus-
    and owned-encoder-backed ``OpusEncoder``, the system's libopus for the
    voice clips, and the JAX package's Ogg writer) makes the committed
    streams and their index byte for byte; it also checks that every CELT
    packet is single-frame 20 ms CELT and which clips carry postfilter and
    transient frames, and that every voice clip keeps its mode and
    bandwidth."""
    generate_opus_fixtures(tmp_path)
    names = (*opus_fixtures.CLIPS, *opus_fixtures.VOICE_CLIPS)
    for name in (*(f"{c}.opus" for c in names), "index.json"):
        assert (tmp_path / name).read_bytes() == (opus_fixtures.FIXTURE_DIR / name).read_bytes(), name


def test_opus_fixtures_cover_the_decode_paths():
    """By the JAX package's CELT parse of every packet: libopus clips
    with the comb postfilter on most frames and transient frames, the
    owned encoder's with neither postfilter nor pre-skip; mono and
    stereo; an OpusHead output gain; every lane of the smoke cut a whole
    Ogg stream the JAX demuxer reads back."""
    from soundkit_tpu.codecs.celt_native import NativeCeltParser
    from soundkit_tpu.codecs.opus import OggOpusDemuxer
    from soundkit_tpu.codecs.opus_core import TOC_ATTRS
    from soundkit_tpu.codecs.opus_tables import tables

    band_end = tables()["celt_band_end"].astype(int)
    seen = {}
    for clip in opus_fixtures.load_clips():
        parser, pf, short = NativeCeltParser(clip.channels), 0, 0
        for pkt in clip.packets:
            mode, dur, stereo, bw, code = TOC_ATTRS[pkt[0]]
            assert (mode, dur, code, 2 if stereo else 1) == ("celt", 20, 0, clip.channels)
            _, comb, sflag = parser.parse(pkt[1:], band_end[bw], clip.channels)
            pf += bool(comb[2:8].any() or comb[10:16].any())
            short += sflag
        seen[clip.name] = (pf, short, clip.pre_skip, clip.output_gain, clip.channels)
    assert seen["owned"][:3] == (0, seen["owned"][1], 0) and seen["owned"][1] > 0
    for name in ("stereo96", "mono64", "gain"):
        pf, short, pre_skip, _, _ = seen[name]
        assert pf > 90 and short >= 10 and pre_skip == 312, (name, seen[name])
    assert seen["gain"][3] == -1200 and seen["mono64"][4] == 1
    clips = opus_fixtures.load_clips()
    for i, data in enumerate(opus_fixtures.lane_streams(clips, 16)):
        dm = OggOpusDemuxer()
        clip, idx = opus_fixtures.lane_packets(clips, i)
        assert dm.push(data) == [clip.packets[t] for t in idx] and dm.head.raw == clip.head


def test_opus_voice_fixtures_cover_the_decode_paths():
    """By their TOCs and the JAX package's SILK walk: SILK NB, MB and WB
    mono, SILK WB stereo with mono-coded packets, mid-only frames and a
    side-channel reset, hybrid SWB mono and FB stereo; single-frame 20 ms
    packets, pre-skip 312, an OpusHead gain on the MB clip; every lane of
    a smoke cut a whole Ogg stream the JAX demuxer reads back; each clip
    under 40 KB."""
    from soundkit_tpu.codecs.opus import OggOpusDemuxer
    from soundkit_tpu.codecs.opus_core import TOC_ATTRS
    from soundkit_tpu.codecs.silk_native import NativeSilkBatch

    clips = opus_fixtures.load_clips(names=opus_fixtures.VOICE_CLIPS)
    want = {"silk_nb": ("silk", 0, 1), "silk_mb": ("silk", 1, 1), "silk_wb": ("silk", 2, 1),
            "silk_wb_stereo": ("silk", 2, 2), "hybrid_swb": ("hybrid", 3, 1),
            "hybrid_fb": ("hybrid", 4, 2)}
    for clip in clips:
        mode, bw, ch = want[clip.name]
        assert clip.channels == ch and clip.pre_skip == 312 and len(clip.stream()) < 40_000
        tocs = [TOC_ATTRS[p[0]] for p in clip.packets]
        assert {(m, d, b, c) for m, d, _, b, c in tocs} == {(mode, 20, bw, 0)}, clip.name
        stereo = {s for _, _, s, _, _ in tocs}
        assert stereo == ({False, True} if clip.name == "silk_wb_stereo" else {ch == 2})
    assert clips[1].output_gain == -600
    stereo = clips[3]
    walk = NativeSilkBatch(1, 2)
    flags = []
    for pkt in stereo.packets:
        p = walk.parse_many([pkt[1:]], [2], [2 if TOC_ATTRS[pkt[0]][2] else 1], [20], [1])
        assert p["n"][0] == 320
        flags.append(p["flags"][0])
    flags = np.array(flags)
    assert flags[:, 3].sum() > 10 and flags[1:, 4].any()  # mid-only frames, a side reset
    for i, data in enumerate(opus_fixtures.lane_streams(clips, 18)):
        dm = OggOpusDemuxer()
        clip, idx = opus_fixtures.lane_packets(clips, i)
        assert dm.push(data) == [clip.packets[t] for t in idx] and dm.head.raw == clip.head


def test_vorbis_fixtures_equal_a_regeneration(tmp_path):
    """The generator (on the test side, with the JAX package's
    libvorbis-backed ``AvEncoder``, its Ogg page writer and
    ``tests/vorbis_craft.py``) makes the committed streams and their index
    byte for byte; it also checks that both stereo clips hold every
    (previous, current) block-size case."""
    generate_vorbis_fixtures(tmp_path)
    for name in (*(f"{c}.ogg" for c in vorbis_fixtures.CLIPS), "index.json"):
        assert (tmp_path / name).read_bytes() == \
            (vorbis_fixtures.FIXTURE_DIR / name).read_bytes(), name


def test_vorbis_fixtures_cover_the_decode_paths():
    """By the JAX package's Ogg packetizer and Vorbis setup: the stereo
    clips at 44.1 kHz with blocksizes (256, 2048), square-polar coupling
    and short blocks; the mono clip of another topology; the crafted
    floor0 clip with n0 == n1; every audio page whole packets, so that
    every lane of a cut is a stream the JAX decoder reads from its first
    audio packet on; the set under 400 KB."""
    from soundkit_tpu.codecs.vorbis_core import Floor0, Floor1, VorbisSetup
    from soundkit_tpu.demux.ogg import OggPacketizer

    clips = vorbis_fixtures.load_clips()
    seen = {}
    for clip in clips:
        pk = OggPacketizer()
        headers = [p for p, _ in pk.push(clip.header)]
        setup = VorbisSetup(headers[0], headers[2])
        floors = {type(f) for f in setup.floors}
        sizes = []
        for page in clip.pages:
            got = [p for p, _ in pk.push(page)]
            assert got and not pk._partial, clip.name
            sizes += [setup.decode_packet_spectrum(p).n for p in got]
        coupled = any(m.coupling for m in setup.mappings)
        seen[clip.name] = (setup.sample_rate, setup.channels, setup.blocksize0,
                           setup.blocksize1, floors, coupled, sizes.count(setup.blocksize0) > 0)
        assert (clip.rate, clip.channels, *clip.blocksizes) == seen[clip.name][:4]
    for name in vorbis_fixtures.STEREO:
        assert seen[name] == (44100, 2, 256, 2048, {Floor1}, True, True), name
    assert seen["mono22"][:5] == (22050, 1, 512, 1024, {Floor1})
    assert seen["floor0"][:5] == (8000, 1, 256, 256, {Floor0})
    total = sum(len(c.stream()) for c in clips)
    assert total < 400_000
    for i, data in enumerate(vorbis_fixtures.lane_streams(clips[:2], 12)):
        clip, idx = vorbis_fixtures.lane_pages(clips[:2], i)
        assert data == clip.header + b"".join(clip.pages[t] for t in idx)
