"""The port's own copies of the JAX package's host pieces equal the
originals: tables and the functions that make them, the G.726 code
packing, the ADTS framer, the wire packers (byte for byte, each with
its own package's parser), the C++ sources of the AAC parser, the FLAC
walk, the MP3 parser and the Opus parse (CELT, SILK, the hybrid glue),
the MP3 synthesis tables, format detection, the FLAC segment-table
packer, and the Opus host layer: the RFC 6716 tables, the TOC parse, the
Ogg packetizer, the OpusHead and Ogg Opus demuxer, the CELT IMDCT basis
and comb packing, the CELT parse's serving walk on both wires, the SILK
walk's binding (a verbatim subset of ``codecs/silk_native.py``), its
resampler plan and the hybrid walk's packed wire; and the Vorbis host
layer: the C++ packet parse, its table, the Python decoder and the
parse's binding; the owned host codecs: the GSM and ALAC C++ decoders,
the AC-3 and Speex cores and their tables, the AIFF, ALAC, Speex and
GSM / AC-3 decoders, the CAF and MP4 demuxers and the ALAC / M4A and
streaming adapters (each a copy but for its named difference); the
container layer: the WebM, MPEG-TS and LOAS/LATM demuxers, the track
demuxer and ``simple.AudioTrackDemuxer``, ``AacLatmAdapter`` and
``WebmAdapter`` (but for their owned decoders); and the
FLAC encode host layer: the C++ frame packer,
the Python frame encoder (a verbatim copy but for its ``_native_lib``)
and the encoder's plan layout and per-frame oracle; and the numpy halves of
the resampler and the phase vocoder with the host modules above them
(``core/``, ``pipeline/``, ``stretch.py``), their imports turned to the
port's."""
from pathlib import Path

import numpy as np
import pytest

from soundkit_tpu.codecs import aac_lc as jax_aac_lc
from soundkit_tpu.codecs import g726 as jax_g726
from soundkit_tpu.codecs.aac_lc_native import (
    NativeAacParser,
    _v4_views,
    prepare_frame_batch_grouped,
    prepare_v4_batch_packed,
)
from soundkit_tpu.ops import aac_batch as jax_aac_batch
from soundkit_tpu.ops import aac_dsp as jax_aac_dsp
from soundkit_tpu.ops import aac_entropy as jax_aac_entropy
from soundkit_tpu.ops import adpcm as jax_adpcm
from soundkit_tpu.ops import g722 as jax_g722
from soundkit_tpu_torch.codecs import aac_lc, aac_lc_native, g726
from soundkit_tpu_torch.native import AacHostParser
from soundkit_tpu_torch.ops import aac_batch, aac_dsp, aac_entropy, adpcm, g722
from soundkit_tpu_torch.tools import aac_fixtures

from torch_port_helpers import SR_INDEX_48K, picked_aus

REPO = Path(__file__).resolve().parent.parent

G722_TABLES = ("WL", "RL42", "ILB", "WH", "RH2", "QM2", "QM4", "QM6", "QMF_COEFFS",
               "Q6", "ILN", "ILP", "IHN", "IHP")


@pytest.mark.parametrize("port,ref", [
    ("soundkit_tpu_torch/native_src/src/aac_parse.cpp", "soundkit_tpu/native/src/aac_parse.cpp"),
    ("soundkit_tpu_torch/native_src/generated/aac_tables.h",
     "soundkit_tpu/native/generated/aac_tables.h"),
    ("soundkit_tpu_torch/data/aac_tables.npz", "soundkit_tpu/native/generated/aac_tables.npz"),
    ("soundkit_tpu_torch/native_src/src/flac.cpp", "soundkit_tpu/native/src/flac.cpp"),
    ("soundkit_tpu_torch/native_src/src/mp3_parse.cpp", "soundkit_tpu/native/src/mp3_parse.cpp"),
    ("soundkit_tpu_torch/native_src/generated/mp3_tables.h",
     "soundkit_tpu/native/generated/mp3_tables.h"),
    ("soundkit_tpu_torch/data/mp3_tables.npz", "soundkit_tpu/native/generated/mp3_tables.npz"),
    ("soundkit_tpu_torch/demux/detect.py", "soundkit_tpu/demux/detect.py"),
    ("soundkit_tpu_torch/native_src/src/celt_parse.cpp", "soundkit_tpu/native/src/celt_parse.cpp"),
    ("soundkit_tpu_torch/data/opus_tables.npz", "soundkit_tpu/native/generated/opus_tables.npz"),
    ("soundkit_tpu_torch/native_src/src/silk_parse.cpp", "soundkit_tpu/native/src/silk_parse.cpp"),
    ("soundkit_tpu_torch/native_src/src/hybrid_glue.cpp", "soundkit_tpu/native/src/hybrid_glue.cpp"),
    ("soundkit_tpu_torch/native_src/src/vorbis_parse.cpp",
     "soundkit_tpu/native/src/vorbis_parse.cpp"),
    ("soundkit_tpu_torch/data/vorbis_tables.npz", "soundkit_tpu/native/generated/vorbis_tables.npz"),
    ("soundkit_tpu_torch/native_src/src/flac_pack.cpp", "soundkit_tpu/native/src/flac_pack.cpp"),
    ("soundkit_tpu_torch/native_src/src/gsm.cpp", "soundkit_tpu/native/src/gsm.cpp"),
    ("soundkit_tpu_torch/native_src/src/alac.cpp", "soundkit_tpu/native/src/alac.cpp"),
    ("soundkit_tpu_torch/data/ac3_tables.npz", "soundkit_tpu/native/generated/ac3_tables.npz"),
    ("soundkit_tpu_torch/data/speex_tables.npz", "soundkit_tpu/native/generated/speex_tables.npz"),
])
def test_copied_files_are_identical(port, ref):
    assert (REPO / port).read_bytes() == (REPO / ref).read_bytes()


def test_aac_constants_and_codebooks():
    assert aac_lc.SAMPLE_RATES == jax_aac_lc.SAMPLE_RATES
    for name in ("ONLY_LONG_SEQUENCE", "LONG_START_SEQUENCE", "EIGHT_SHORT_SEQUENCE",
                 "LONG_STOP_SEQUENCE"):
        assert getattr(aac_lc, name) == getattr(jax_aac_lc, name), name
    assert aac_lc._CB_INFO == jax_aac_lc._CB_INFO
    for cb, (dim, base, _signed) in aac_lc._CB_INFO.items():
        for idx in range(base**dim):
            assert aac_lc._unpack_index(cb, idx) == jax_aac_lc._unpack_index(cb, idx)


def test_spectral_lut():
    assert aac_entropy.LUT_BITS == jax_aac_entropy.LUT_BITS
    np.testing.assert_array_equal(aac_entropy.build_spectral_lut(),
                                  jax_aac_entropy.build_spectral_lut())


@pytest.mark.parametrize("n", [1024, 128])
def test_imdct_matrix(n):
    np.testing.assert_array_equal(aac_dsp.imdct_matrix(n), jax_aac_dsp.imdct_matrix(n))


def test_window_banks():
    np.testing.assert_array_equal(aac_batch.window_bank(), jax_aac_batch.window_bank())
    np.testing.assert_array_equal(aac_batch.short_window_bank(), jax_aac_batch.short_window_bank())
    assert (aac_batch.MAX_ORDER, aac_batch.MAX_FILTERS) == \
        (jax_aac_batch.MAX_ORDER, jax_aac_batch.MAX_FILTERS)


@pytest.mark.parametrize("B", [1, 3, 1024])
def test_v4_wire_layout(B):
    port, ref = aac_batch.v4_wire_layout(B), jax_aac_batch.v4_wire_layout(B)
    assert port[1] == ref[1]
    assert [(n, o, np.dtype(d), s) for n, o, d, s in port[0]] == \
        [(n, o, np.dtype(d), s) for n, o, d, s in ref[0]]


@pytest.mark.parametrize("bits", [2, 3, 4, 5])
def test_g726_tables(bits):
    port, ref = adpcm.g726_tables(bits), jax_adpcm.g726_tables(bits)
    assert port.keys() == ref.keys()
    for k in port:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(adpcm.POWER2, jax_adpcm.POWER2)


def test_g722_tables():
    for name in G722_TABLES:
        np.testing.assert_array_equal(getattr(g722, name), getattr(jax_g722, name), err_msg=name)


@pytest.mark.parametrize("packing", ["LEFT", "RIGHT"])
@pytest.mark.parametrize("bits", [2, 3, 4, 5])
def test_g726_packing(bits, packing):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, 8 * 37).astype(np.uint8)  # whole groups
    port_p, ref_p = g726.G726Packing[packing], jax_g726.G726Packing[packing]
    wire = g726.pack_codes(codes, bits, port_p)
    assert wire == jax_g726.pack_codes(codes, bits, ref_p)
    np.testing.assert_array_equal(g726.unpack_codes(wire, bits, port_p), codes)
    np.testing.assert_array_equal(g726.unpack_codes(wire, bits, port_p),
                                  jax_g726.unpack_codes(wire, bits, ref_p))
    for rate in g726.G726Rate:
        ref_rate = jax_g726.G726Rate[rate.name]
        assert (rate.value, rate.bit_rate, rate.samples_per_byte_group, rate.bytes_per_group) == \
            (ref_rate.value, ref_rate.bit_rate, ref_rate.samples_per_byte_group,
             ref_rate.bytes_per_group)


@pytest.mark.parametrize("chunk", [None, 313, 1])
def test_adts_stream_frames_like_the_jax_package(chunk):
    """Every committed clip, whole or in odd-sized pushes (one byte at a
    time for the first 3 KB), with a garbage prefix to resync over."""
    for name in aac_fixtures.CLIPS:
        data = b"\x00\xff\x12" + (aac_fixtures.FIXTURE_DIR / f"{name}.aac").read_bytes()
        if chunk == 1:
            data = data[:3000]
        port, ref = aac_lc.AdtsStream(), jax_aac_lc.AdtsStream()
        step = chunk or len(data)
        got, want = [], []
        for i in range(0, len(data), step):
            got += port.push(data[i : i + step])
            want += ref.push(data[i : i + step])
        assert got == want and len(got) > 0, name
        assert (port.sr_index, port.channel_config) == (ref.sr_index, ref.channel_config)


def test_v4_packer_is_byte_identical():
    """The port's packer over its parser against the JAX package's over
    its own, on the same AUs with an idle lane; both parsers fresh."""
    aus = picked_aus()
    aus[5] = None
    got, got_steps, got_over = aac_lc_native.prepare_v4_batch_packed(
        AacHostParser(SR_INDEX_48K), aus)
    want, want_steps, want_over = prepare_v4_batch_packed(NativeAacParser(SR_INDEX_48K), aus)
    np.testing.assert_array_equal(got, want)
    assert (got_steps, got_over) == (want_steps, want_over)
    port_views, ref_views = aac_lc_native.v4_views(got, len(aus)), _v4_views(want, len(aus))
    assert port_views.keys() == ref_views.keys()


def test_full_wire_packer_is_byte_identical():
    aus = picked_aus()
    aus[3] = None
    lane_sr = [SR_INDEX_48K] * len(aus)
    got = aac_lc_native.prepare_frame_batch_grouped({SR_INDEX_48K: AacHostParser(SR_INDEX_48K)},
                                                    lane_sr, aus)
    want = prepare_frame_batch_grouped({SR_INDEX_48K: NativeAacParser(SR_INDEX_48K)}, lane_sr, aus)
    fields = [f for f in vars(want)]
    assert fields == list(vars(got))
    for field in fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def _function_source(module, name: str) -> str:
    import inspect

    return inspect.getsource(getattr(module, name))


def test_flac_seg_wire_is_a_verbatim_copy_and_packs_alike():
    from soundkit_tpu.ops import flac_rice as jax_flac_rice
    from soundkit_tpu_torch.ops import flac_rice

    assert _function_source(flac_rice, "seg_wire") == _function_source(jax_flac_rice, "seg_wire")
    rng = np.random.default_rng(5)
    tables = [rng.integers(0, 4000, (n, 4)).astype(np.int32) for n in (3, 0, 70, 1)]
    for frame_segs in (tables, [tables[1]], tables[:1]):
        for got, want in zip(flac_rice.seg_wire(frame_segs, 4608),
                             jax_flac_rice.seg_wire(frame_segs, 4608)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_flac_walk_library_exports_the_wire_of_the_jax_package():
    """The port's ``flac.cpp`` build and the JAX package's library give
    the same wire for the same pushes (``skt_flac_export_rounds``)."""
    from soundkit_tpu.models.flac_batch import BatchedFlacDecoder as JaxDecoder
    from soundkit_tpu_torch.models.flac_batch import BatchedFlacDecoder
    from soundkit_tpu_torch.tools import flac_fixtures

    streams = flac_fixtures.lane_streams(flac_fixtures.load_clips(), 4, 2)
    port, probe = BatchedFlacDecoder(4, device="cpu"), BatchedFlacDecoder(4, device="cpu")
    probe._lib = JaxDecoder(1)._lib  # the same calls through the other library
    probe._h = [probe._lib.skt_flac_new() for _ in range(4)]
    import ctypes
    probe._handles = (ctypes.c_void_p * 4)(*probe._h)
    for m in (port, probe):
        for i, s in enumerate(streams):
            m.push(i, s)
    a, b = port.export_wire(2), probe.export_wire(2)
    for x, y in zip((*a.segs, *a.metas, *a.parts), (*b.segs, *b.metas, *b.parts)):
        np.testing.assert_array_equal(x, y)
    assert int(a.segs[4].sum()) > 20000  # codes on the wire


MP3_BUILDERS = ("imdct_matrix", "imdct_windows", "short_window", "synth_matrix", "synth_window")


@pytest.mark.parametrize("name", MP3_BUILDERS)
def test_mp3_table_builders_are_verbatim_copies(name):
    """Each builder of the port's ``ops/mp3_dsp.py`` is the JAX package's
    function, source and values (the D window's mirror exception at 64,
    128 and 192 included), over the port's copy of the table file."""
    from soundkit_tpu.ops import mp3_dsp as jax_mp3_dsp
    from soundkit_tpu_torch.ops import mp3_dsp

    assert _function_source(mp3_dsp, name) == _function_source(jax_mp3_dsp, name)
    args = (36, 12) if name == "imdct_matrix" else (None,)
    for a in args:
        got = getattr(mp3_dsp, name)(*([a] if a else []))
        want = getattr(jax_mp3_dsp, name)(*([a] if a else []))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_mp3_alias_coefficients_and_gather_tables():
    from soundkit_tpu.ops import mp3_batch as jax_mp3_batch
    from soundkit_tpu.ops import mp3_dsp as jax_mp3_dsp
    from soundkit_tpu_torch.ops import mp3_dsp, mp3_synth

    np.testing.assert_array_equal(mp3_dsp.CS, jax_mp3_dsp.CS)
    np.testing.assert_array_equal(mp3_dsp.CA, jax_mp3_dsp.CA)
    for got, want in zip(mp3_synth._alias_idx(), jax_mp3_batch._alias_idx()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mp3_synth.u_indices(), jax_mp3_batch._u_indices())


def test_mp3_parser_library_pops_the_wire_of_the_jax_package():
    """The port's ``mp3_parse.cpp`` build and the JAX package's library
    give the same packed wire for the same pushes (``skt_mp3_pop_rounds``),
    and the same single pops."""
    from soundkit_tpu.codecs.mp3_native import NativeMp3Parser as JaxParser
    from soundkit_tpu.models.mp3_batch_model import BatchedMp3Decoder as JaxDecoder
    from soundkit_tpu_torch.codecs.mp3_native import NativeMp3Parser
    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.tools import mp3_fixtures

    streams = mp3_fixtures.lane_streams(mp3_fixtures.load_clips(), 5, 12)
    port, ref = BatchedMp3Decoder(5, device="cpu"), JaxDecoder(5)
    for m in (port, ref):
        for i, s in enumerate(streams):
            m.push(i, s)
    np.testing.assert_array_equal(port._pop_rounds(30), ref._pop_rounds(30))
    assert port._counts == ref._counts and (port._rates == ref._rates).all()
    a, b = NativeMp3Parser(), JaxParser()
    assert a.push(streams[1]) == b.push(streams[1]) > 0
    for _ in range(3):
        (qa, ea, ma), (qb, eb, mb_) = a.pop(), b.pop()
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(ea, eb)
        assert ma == mb_


# ---------------------------------------------------------------------------
# Opus
# ---------------------------------------------------------------------------

def test_opus_tables_module_is_a_copy_but_for_its_table_path():
    """``codecs/opus_tables.py`` differs from the original in the path of
    its table file alone, and reads the same tables."""
    from soundkit_tpu.codecs import opus_tables as jax_tables
    from soundkit_tpu_torch.codecs import opus_tables

    port = (REPO / "soundkit_tpu_torch/codecs/opus_tables.py").read_text().splitlines()
    ref = (REPO / "soundkit_tpu/codecs/opus_tables.py").read_text().splitlines()
    diff = [(a, b) for a, b in zip(port, ref) if a != b]
    assert len(port) == len(ref) and len(diff) == 1 and diff[0][0].startswith("_NPZ = ")
    got, want = opus_tables.tables(), jax_tables.tables()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert opus_tables.PVQ_U_ROW_OFFSETS == jax_tables.PVQ_U_ROW_OFFSETS


OPUS_COPIES = [
    ("codecs.opus_celt", "_imdct_matrix"),
    ("codecs.opus_core", "OpusUnsupported"),
    ("codecs.opus_core", "Toc"),
    ("codecs.opus_core", "parse_packet"),
    ("demux.ogg", "OggPage"),
    ("demux.ogg", "OggPageParser"),
    ("demux.ogg", "OggPacketizer"),
    ("codecs.opus", "OpusHead"),
    ("codecs.opus", "OggOpusDemuxer"),
    ("ops.celt_batch", "_bases"),
    ("ops.celt_batch", "_win2"),
    ("ops.celt_batch", "pack_comb_params"),
]


@pytest.mark.parametrize("module,name", OPUS_COPIES)
def test_opus_host_pieces_are_verbatim_copies(module, name):
    import importlib

    port = importlib.import_module(f"soundkit_tpu_torch.{module}")
    ref = importlib.import_module(f"soundkit_tpu.{module}")
    assert _function_source(port, name) == _function_source(ref, name)


def test_opus_constants_and_toc_tables():
    from soundkit_tpu.codecs import opus_celt as jax_celt
    from soundkit_tpu.codecs import opus_core as jax_core
    from soundkit_tpu_torch.codecs import opus_celt, opus_core

    for name in ("OVERLAP", "CELT_EMPH_COEFF"):
        assert getattr(opus_celt, name) == getattr(jax_celt, name), name
    assert opus_core.TOC_ATTRS == jax_core.TOC_ATTRS
    assert [(t.config, t.stereo, t.code) for t in opus_core._TOC_CACHE] == \
        [(t.config, t.stereo, t.code) for t in jax_core._TOC_CACHE]
    for nb in (960, 120):
        np.testing.assert_array_equal(opus_celt._imdct_matrix(nb), jax_celt._imdct_matrix(nb))


def test_ogg_opus_demux_splits_like_the_jax_package():
    """Every committed Ogg Opus clip, whole and in odd-sized pushes: the
    same OpusHead and packets; and the TOC parse of code 0-3 packets."""
    from soundkit_tpu.codecs.opus import OggOpusDemuxer as JaxDemuxer
    from soundkit_tpu.codecs.opus_core import parse_packet as jax_parse
    from soundkit_tpu_torch.codecs.opus import OggOpusDemuxer
    from soundkit_tpu_torch.codecs.opus_core import OpusUnsupported, parse_packet
    from soundkit_tpu_torch.tools import opus_fixtures

    for clip in opus_fixtures.load_clips():
        data = clip.stream()
        for step in (len(data), 997, 61):
            port, ref = OggOpusDemuxer(), JaxDemuxer()
            got, want = [], []
            for i in range(0, len(data), step):
                got += port.push(data[i: i + step])
                want += ref.push(data[i: i + step])
            assert got == want == clip.packets
            assert port.head.raw == ref.head.raw == clip.head
    pkt = opus_fixtures.load_clips()[0].packets[5]
    body = pkt[1:]
    cases = [pkt, bytes([pkt[0] | 1]) + body[:40] + body[:40],
             bytes([pkt[0] | 2, 30]) + body[:70], bytes([pkt[0] | 3, 0x83, 20, 11]) + body[:50],
             bytes([pkt[0] | 3, 0x42, 3]) + body[:40] + bytes(3), bytes([pkt[0] | 3, 0])]
    for c in cases:
        try:
            want = jax_parse(c)
        except ValueError as e:
            with pytest.raises(OpusUnsupported, match=str(e)):
                parse_packet(c)
            continue
        toc, frames = parse_packet(c)
        assert (toc.config, toc.stereo, toc.code, frames) == \
            (want[0].config, want[0].stereo, want[0].code, want[1])


@pytest.mark.parametrize("quantized", [False, True])
def test_celt_parse_library_walks_the_wire_of_the_jax_package(quantized):
    """The port's ``celt_parse.cpp`` build and the JAX package's library
    give the same serving wire (``skt_celt_parse_rounds`` / ``_q``) for
    the same rounds of the Opus fixtures, ragged lanes and a mono clip in
    stereo lanes among them: the comb parameters, transient flags, parse
    results and band scales equal, the spectra up to the compilers'
    rounding."""
    from soundkit_tpu.codecs.celt_native import NativeCeltBatch as JaxBatch
    from soundkit_tpu.models.opus_batch import BatchedCeltDecoder as JaxDecoder
    from soundkit_tpu_torch.codecs.celt_native import NativeCeltBatch
    from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder
    from soundkit_tpu_torch.tools import opus_fixtures

    B, R = 6, 9
    raws = [opus_fixtures.lane_raw(opus_fixtures.load_clips(), B, R - i)[i] for i in range(B)]
    lanes = BatchedCeltDecoder(B, 2, device="cpu")
    for i, r in enumerate(raws):
        lanes.push(i, r)
    lens, ends, coded = (np.zeros((B, R), np.int32) for _ in range(3))
    base, parts, pos = np.zeros(B, np.int64), [], 0
    for b, q in enumerate(lanes._packets):
        lens[b, :len(q)] = [len(t[0]) for t in q]
        ends[b, :len(q)] = [t[1] for t in q]
        coded[b, :len(q)] = [t[2] for t in q]
        base[b] = pos
        parts += [t[0] for t in q]
        pos += sum(len(t[0]) for t in q)
    buf = b"".join(parts)
    assert JaxDecoder(1)._native is not None
    got = NativeCeltBatch(B, 2).parse_rounds(buf, base, lens, ends, coded, R, 800, quantized)
    want = JaxBatch(B, 2).parse_rounds(buf, base, lens, ends, coded, R, 800, quantized)
    for g, w in zip(got[1:], want[1:]):  # scales, comb, sflag, ok: equal
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the spectra: the JAX package builds its library with -march=native, so
    # the compiler fuses products into FMAs that the port's portable build
    # rounds apart; spectra differ by float rounding near zero (~1e-17 of
    # the largest value), the int16 wire by 1 on a few of its 86,400 values
    g, w = got[0].astype(np.float64), want[0].astype(np.float64)
    assert got[0].dtype == want[0].dtype
    if quantized:
        assert np.abs(g - w).max() <= 1 and (g != w).mean() < 1e-3
    else:
        assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max()
    assert (got[4][lens.T > 0] == 0).all() and (got[4][lens.T == 0] == -100).all()
    assert np.abs(got[0]).max() > 0


SILK_NATIVE_COPIES = [
    ("SilkNativeError", None), ("NativeSilkDecoder", "__init__"), ("NativeSilkDecoder", "__del__"),
    ("NativeSilkDecoder", "flush"), ("NativeSilkBatch", "reset_lane"),
    ("NativeSilkBatch", "parse_many"), ("NativeSilkBatch", "hybrid_parse_rounds_packed"),
    ("NativeSilkBatch", "decode_many"), ("NativeSilkBatch", "hybrid_parse_rounds"),
]


@pytest.mark.parametrize("cls,method", SILK_NATIVE_COPIES)
def test_silk_native_is_a_verbatim_subset(cls, method):
    import inspect

    from soundkit_tpu.codecs import silk_native as jax_silk
    from soundkit_tpu_torch.codecs import silk_native

    port, ref = getattr(silk_native, cls), getattr(jax_silk, cls)
    if method is not None:
        port, ref = getattr(port, method), getattr(ref, method)
    assert inspect.getsource(port) == inspect.getsource(ref)
    assert silk_native._TABLE_KEYS == jax_silk._TABLE_KEYS


@pytest.mark.parametrize("module,name", [("ops.silk_batch", "_resample_plan"),
                                         ("ops.silk_batch", "lead_invalid"),
                                         ("models.opus_batch", "_wire_views")])
def test_silk_and_hybrid_host_pieces_are_verbatim_copies(module, name):
    import importlib

    port = importlib.import_module(f"soundkit_tpu_torch.{module}")
    ref = importlib.import_module(f"soundkit_tpu.{module}")
    assert _function_source(port, name) == _function_source(ref, name)


def test_silk_constants_equal_the_jax_package():
    from soundkit_tpu.ops import silk_batch as jax_sb
    from soundkit_tpu_torch.ops import silk_batch, silk_synth

    for name in ("SFL", "ORDER", "RATE", "HIST", "MAXLAG", "FRAME48", "LTP_ORDER", "SUBFRAMES"):
        assert getattr(silk_batch, name) == getattr(jax_sb, name), name
    for name in ("SFL", "ORDER", "HIST", "MAXLAG", "LTP_ORDER", "SUBFRAMES"):
        assert getattr(silk_synth, name) == getattr(jax_sb, name), name


@pytest.mark.parametrize("C", [1, 2])
def test_hybrid_wire_layout_equals_the_jax_package(C):
    from soundkit_tpu.models import opus_batch as jax_ob
    from soundkit_tpu_torch.models import opus_batch

    for exc16 in (True, False):
        assert opus_batch._hybrid_wire_layout(8, 5, C, exc16) == \
            jax_ob._hybrid_wire_layout(8, 5, C, exc16)
    assert (opus_batch.ROUNDS_PER_CALL, opus_batch._EXC_Q, opus_batch._HYB_BIN_LO,
            opus_batch._HYB_BIN_HI) == (jax_ob.ROUNDS_PER_CALL, jax_ob._EXC_Q, jax_ob._HYB_BIN_LO,
                                         jax_ob._HYB_BIN_HI)


def test_opus_library_walks_the_hybrid_wire_of_the_jax_package():
    """The port's one Opus library (``celt_parse.cpp``, ``silk_parse.cpp``
    and ``hybrid_glue.cpp``) and the JAX package's give the same packed
    hybrid wire for a chunk of the fixtures' hybrid packets (every integer
    field equal, the float planes up to the compilers' rounding), and the
    same walk results."""
    from soundkit_tpu.codecs.celt_native import NativeCeltBatch as JaxCelt
    from soundkit_tpu.codecs.silk_native import NativeSilkBatch as JaxSilk
    from soundkit_tpu_torch.codecs.celt_native import NativeCeltBatch
    from soundkit_tpu_torch.codecs.silk_native import NativeSilkBatch
    from soundkit_tpu_torch.models import opus_batch
    from soundkit_tpu_torch.tools import opus_fixtures

    clips = opus_fixtures.load_clips(names=("hybrid_swb", "hybrid_fb"))
    B, R, C = 3, 8, 2
    lanes = [opus_fixtures.lane_frames(clips, b, R - b) for b in range(B)]
    band_end = opus_batch.tables()["celt_band_end"].astype(int)
    plens, ends, coded = (np.zeros((B, R), np.int32) for _ in range(3))
    base, parts, pos = np.zeros(B, np.int64), [], 0
    for b, fr in enumerate(lanes):
        plens[b, :len(fr)] = [len(f) for f, _, _ in fr]
        ends[b, :len(fr)] = [band_end[bw] for _, bw, _ in fr]
        coded[b, :len(fr)] = [c for _, _, c in fr]
        base[b] = pos
        parts += [f for f, _, _ in fr]
        pos += sum(len(f) for f, _, _ in fr)
    buf = b"".join(parts)
    layout, total = opus_batch._hybrid_wire_layout(R, B, C, True)
    offs = np.array([dict((n, o) for n, o, _, _ in layout)[k] for k in (
        "exc", "gains", "coef", "ltp", "ltpscale", "stereo_w", "freq", "comb", "lags", "hl", "vo",
        "cc", "um", "sr", "sflag")], np.int64)
    out = []
    for silk, celt in ((NativeSilkBatch(B, C), NativeCeltBatch(B, C)), (JaxSilk(B, C), JaxCelt(B, C))):
        wire = np.zeros(total, np.uint8)
        exc = np.zeros((R, B, 2, 320))
        res = silk.hybrid_parse_rounds_packed(celt, buf, base, plens, ends, coded, wire, offs, exc)
        out.append((opus_batch._wire_views(wire, R, B, C, True), res))
    (got, gres), (want, wres) = out
    for g, w in zip(gres, wres):
        np.testing.assert_array_equal(g, w)
    for k in want:
        if want[k].dtype == np.float32:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-6 * max(np.abs(want[k]).max(), 1e-30))
        else:
            assert np.abs(got[k].astype(np.int64) - want[k]).max() <= (1 if k == "exc" else 0), k
    assert np.abs(want["freq"]).max() > 0 and np.abs(want["exc"]).max() > 0


# ---------------------------------------------------------------------------
# Vorbis
# ---------------------------------------------------------------------------

def test_vorbis_core_is_a_copy_but_for_its_table_path():
    """``codecs/vorbis_core.py`` differs from the original in the path of
    its table file alone, and reads the same floor1 table."""
    from soundkit_tpu.codecs import vorbis_core as jax_core
    from soundkit_tpu_torch.codecs import vorbis_core

    port = (REPO / "soundkit_tpu_torch/codecs/vorbis_core.py").read_text().splitlines()
    ref = (REPO / "soundkit_tpu/codecs/vorbis_core.py").read_text().splitlines()
    diff = [(a, b) for a, b in zip(port, ref) if a != b]
    assert len(port) == len(ref) and len(diff) == 1
    assert diff[0][0].strip().startswith("path = ") and '"data" / "vorbis_tables.npz"' in diff[0][0]
    got, want = vorbis_core.floor1_inverse_db_table(), jax_core.floor1_inverse_db_table()
    assert got.dtype == want.dtype and got.shape == (256,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["VorbisNativeUnsupported", "_i32", "_ptr_i32",
                                  "NativeVorbisParser"])
def test_vorbis_native_is_the_jax_module_but_for_its_library(name):
    """Every piece of ``codecs/vorbis_native.py`` but ``_lib`` (which
    returns the port's build, ``native.vorbis_library``) is the JAX
    package's source."""
    from soundkit_tpu.codecs import vorbis_native as jax_native
    from soundkit_tpu_torch.codecs import vorbis_native

    assert _function_source(vorbis_native, name) == _function_source(jax_native, name)
    names = {n for n in vars(vorbis_native) if not n.startswith("__")}
    assert {n for n in names if callable(getattr(vorbis_native, n))
            and getattr(getattr(vorbis_native, n), "__module__", "") == vorbis_native.__name__} \
        == {"VorbisNativeUnsupported", "_i32", "_ptr_i32", "NativeVorbisParser", "_lib"}


@pytest.mark.parametrize("name", ["window_bank", "init_state"])
def test_vorbis_synthesis_host_pieces_are_verbatim_copies(name):
    from soundkit_tpu.ops import vorbis_batch as jax_vb
    from soundkit_tpu_torch.ops import vorbis_batch

    assert _function_source(vorbis_batch, name) == _function_source(jax_vb, name)


# ---------------------------------------------------------------------------
# FLAC encode
# ---------------------------------------------------------------------------

def test_flac_encode_is_a_copy_but_for_its_native_lib():
    """``codecs/flac_encode.py`` is the JAX package's module with one
    function changed, ``_native_lib`` (the port's packer, which raises
    if it cannot build, where the original falls back to ``None`` through
    two module globals)."""
    from soundkit_tpu.codecs import flac_encode as jax_fe
    from soundkit_tpu_torch.codecs import flac_encode

    port = (REPO / "soundkit_tpu_torch/codecs/flac_encode.py").read_text()
    ref = (REPO / "soundkit_tpu/codecs/flac_encode.py").read_text()
    port = port.replace(_function_source(flac_encode, "_native_lib"), "")
    ref = ref.replace(_function_source(jax_fe, "_native_lib"), "")
    ref = ref.replace("\n\n_UNSET = object()\n_NATIVE = _UNSET\n", "")
    assert port == ref
    assert "soundkit_tpu_torch.native import flac_pack_library" in \
        _function_source(flac_encode, "_native_lib")


@pytest.mark.parametrize("module,name", [("ops.flac_enc_batch", "flac_plans_unpack"),
                                         ("models.flac_encode_batch", "_Lane")])
def test_flac_encode_host_pieces_are_verbatim_copies(module, name):
    import importlib

    port = importlib.import_module(f"soundkit_tpu_torch.{module}")
    ref = importlib.import_module(f"soundkit_tpu.{module}")
    assert _function_source(port, name) == _function_source(ref, name)


def test_flac_encoder_oracle_and_constants_equal_the_jax_package():
    import inspect

    from soundkit_tpu.models import flac_encode_batch as jax_model
    from soundkit_tpu.ops import flac_enc_batch as jax_ops
    from soundkit_tpu_torch.models import flac_encode_batch as model
    from soundkit_tpu_torch.ops import flac_enc_batch as ops

    assert inspect.getsource(model.BatchedFlacEncoder._write_from_plan) == \
        inspect.getsource(jax_model.BatchedFlacEncoder._write_from_plan)
    assert model._SLOT_SOURCES == jax_model._SLOT_SOURCES
    for name in ("LPC_ORDER", "LPC_PRECISION", "MAX_FIXED", "ASSIGN_CODES", "ASSIGN_SLOTS"):
        assert getattr(ops, name) == getattr(jax_ops, name), name


# ---------------------------------------------------------------------------
# the resampler, the phase vocoder and the host modules above them
# ---------------------------------------------------------------------------

def _as_port(text: str) -> str:
    """``text`` with its imports of the JAX package's modules turned to
    the port's (the one change a verbatim copy makes)."""
    import re

    return re.sub(r"^(\s*)from soundkit_tpu\.", r"\1from soundkit_tpu_torch.", text, flags=re.M)


@pytest.mark.parametrize("module", ["core/__init__.py", "core/audio_types.py",
                                    "core/audio_bytes.py", "core/audio_pipeline.py",
                                    "pipeline/__init__.py", "pipeline/resampler.py",
                                    "pipeline/output_options.py", "stretch.py"])
def test_host_modules_are_verbatim_copies(module):
    port = (REPO / "soundkit_tpu_torch" / module).read_text()
    assert port == _as_port((REPO / "soundkit_tpu" / module).read_text())


@pytest.mark.parametrize("name", ["_blackman_harris2", "design_polyphase", "out_len",
                                  "resample_np", "_conv_kernel"])
def test_resample_host_half_is_verbatim(name):
    """The numpy half of ``ops/resample.py``; ``resample_init_state`` is
    not a copy (the port's returns a tensor on the device it is given,
    ``tests/test_torch_resample.py``)."""
    from soundkit_tpu.ops import resample as jax_rs
    from soundkit_tpu_torch.ops import resample as rs

    assert _function_source(rs, name) == _function_source(jax_rs, name)
    assert (rs.SINC_LEN, rs.CUTOFF) == (jax_rs.SINC_LEN, jax_rs.CUTOFF)


@pytest.mark.parametrize("name", ["_princarg", "_spectral_envelope", "_warp_envelope",
                                  "_nearest_peak_np", "stretch_channels", "pitch_ratio_fraction",
                                  "stretch_pitch"])
def test_stretch_host_half_is_verbatim(name):
    from soundkit_tpu.ops import stretch as jax_st
    from soundkit_tpu_torch.ops import stretch as st

    assert _function_source(st, name) == _as_port(_function_source(jax_st, name))
    assert (st.FRAME, st.HOP_A, st.ENVELOPE_ORDER) == \
        (jax_st.FRAME, jax_st.HOP_A, jax_st.ENVELOPE_ORDER)


# ---------------------------------------------------------------------------
# the streaming decode pipeline and its host codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["core/wav.py", "core/raw_pcm.py", "utils/tracing.py",
                                    "ops/aac_dsp.py"])
def test_pipeline_host_modules_are_verbatim_copies(module):
    port = (REPO / "soundkit_tpu_torch" / module).read_text()
    assert port == _as_port((REPO / "soundkit_tpu" / module).read_text())


def test_aac_lc_is_a_copy_but_for_its_table_path():
    port = (REPO / "soundkit_tpu_torch/codecs/aac_lc.py").read_text()
    ref = (REPO / "soundkit_tpu/codecs/aac_lc.py").read_text()
    port = port.replace('parent.parent / "data" / "aac_tables.npz"',
                        'parent.parent / "native" / "generated" / "aac_tables.npz"')
    port = port.replace("\n\n" + _function_source(aac_lc, "raw_tables"), "")
    # the one departure: the port's ADTS framer builds no AacLcDecoder
    # on its first frame (the streaming AacDecoder owns its own), so the
    # batched path's per-stream framers load no VLC tables
    port = port.replace(_function_source(aac_lc, "AdtsStream"),
                        _function_source(jax_aac_lc, "AdtsStream"))
    assert port == ref
    assert not hasattr(aac_lc.AdtsStream(), "decoder")


def _class_methods(cls, names):
    import inspect

    return [inspect.getsource(getattr(cls, n)) for n in names]


@pytest.mark.parametrize("module,name", [
    ("codecs.avdec", "f32_to_i16"), ("codecs.mp3", "_sniff_layer"),
    ("codecs.flac", "decode_flac"), ("pipeline.decode_pipeline", "_audio_i16"),
    ("pipeline.decode_pipeline", "WavAdapter"), ("pipeline.decode_pipeline", "RawPcmAdapter"),
    ("pipeline.decode_pipeline", "FlacAdapter"), ("simple", "PcmFrame"),
    ("simple", "AacLcStreamDecoder"),
])
def test_pipeline_host_pieces_are_verbatim_copies(module, name):
    import importlib

    port = importlib.import_module(f"soundkit_tpu_torch.{module}")
    ref = importlib.import_module(f"soundkit_tpu.{module}")
    assert _function_source(port, name) == _as_port(_function_source(ref, name))


@pytest.mark.parametrize("module,cls,methods", [
    ("codecs.flac", "FlacDecoder", ("__del__", "info", "add", "_drain", "_samples_to_bytes",
                                    "verify_md5")),
    ("codecs.aac", "AacAdtsAdapter", ("_emit", "process", "flush")),
    ("codecs.mp3", "Mp3Adapter", ("_emit", "process", "flush")),
    ("codecs.g722", "G722Encoder", ("encode_i16", "encode_i32", "flush")),
    ("codecs.g726", "G726Decoder", ("decode_i32", "decode_f32", "flush")),
    ("codecs.g726", "G726Encoder", ("encode_i16", "encode_i32", "flush")),
    ("simple", "MusicDecoder", ("push", "flush", "_collect")),
    ("simple", "AacDeboxer", ("__init__",)),
    ("pipeline.decode_pipeline", "StreamDecoder", ("_apply_options",)),
    ("pipeline.decode_pipeline", "DecodePipelineHandle", ("__init__", "send", "finished")),
])
def test_pipeline_classes_keep_the_jax_packages_methods(module, cls, methods):
    """The methods a port class shares with the JAX package's, word for
    word; the rest differ only by the device they are given or the
    libavcodec reroutes the port does not have (the parity tests in
    ``tests/test_torch_streaming_codecs.py`` and
    ``tests/test_torch_pipeline.py`` hold their outputs)."""
    import importlib

    port = getattr(importlib.import_module(f"soundkit_tpu_torch.{module}"), cls)
    ref = getattr(importlib.import_module(f"soundkit_tpu.{module}"), cls)
    props = [m for m in methods if isinstance(getattr(ref, m), property)]
    plain = [m for m in methods if m not in props]
    assert _class_methods(port, plain) == [_as_port(s) for s in _class_methods(ref, plain)]
    import inspect

    for m in props:
        assert inspect.getsource(getattr(port, m).fget) == inspect.getsource(getattr(ref, m).fget)


# ---------------------------------------------------------------------------
# the streaming Opus and Vorbis decoders and the fleet's Opus reroute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["codecs/opus_rc.py", "codecs/opus_silk.py",
                                    "codecs/opus_celt.py"])
def test_opus_codec_modules_are_verbatim_copies(module):
    port = (REPO / "soundkit_tpu_torch" / module).read_text()
    assert port == _as_port((REPO / "soundkit_tpu" / module).read_text())


def test_opus_core_is_a_copy_but_for_its_resampler():
    """``codecs/opus_core.py`` imports the port's SILK resampler
    (``utils/silk_resampler.py``) where the original opens libswresample."""
    port = (REPO / "soundkit_tpu_torch/codecs/opus_core.py").read_text()
    ref = _as_port((REPO / "soundkit_tpu/codecs/opus_core.py").read_text())
    assert port == ref.replace("from soundkit_tpu_torch.utils.swr import SilkResampler",
                               "from soundkit_tpu_torch.utils.silk_resampler import SilkResampler")


def _methods_but(cls, ref_cls, changed):
    import inspect

    names = [n for n, v in vars(ref_cls).items()
             if (inspect.isfunction(v) or isinstance(v, property)) and n not in changed]
    assert set(names) <= set(vars(cls)), set(names) - set(vars(cls))
    return [(n, _source(getattr(cls, n))) for n in names], \
        [(n, _as_port(_source(getattr(ref_cls, n)))) for n in names]


def _source(obj) -> str:
    import inspect

    return inspect.getsource(obj.fget if isinstance(obj, property) else obj)


# (module, class or function, the methods that carry the libavcodec departure)
STREAM_DECODER_COPIES = [
    ("codecs.opus", "OpusHead", ()),
    ("codecs.opus", "_celt_support_window", None),
    ("codecs.opus", "_NativeCeltStream", ()),
    ("codecs.opus", "_OpusCore", ("__init__", "_fallback", "decode_packet_f32", "flush_f32")),
    ("codecs.opus", "OggOpusDemuxer", ()),
    ("codecs.opus", "OggOpusDecoder", ("decode_f32",)),
    ("codecs.opus", "OpusStreamDecoder", ("decode_f32",)),
    ("codecs.vorbis", "xiph_extradata", None),
    ("codecs.vorbis", "split_xiph_extradata", None),
    ("codecs.vorbis", "VorbisPacketDecoder", ("__init__",)),
    ("codecs.vorbis", "VorbisDecoder", ("_init_decoder",)),
    ("codecs.celt_native", "NativeCeltParser", ()),
    ("models.opus_fleet_model", "_OpusTailFallback", ("__init__",)),
    ("simple", "OpusDeboxer", ()),
    ("simple", "OpusDecodeResult", ()),
    ("simple", "OpusDecoder", ()),
    ("codecs.aac", "AacLatmAdapter", ("flush",)),
]


@pytest.mark.parametrize("module,name,changed", STREAM_DECODER_COPIES)
def test_stream_decoder_pieces_are_verbatim_copies(module, name, changed):
    """The streaming decoders' classes and functions equal the JAX
    package's but for their imports and the methods named in the table:
    the libavcodec branches, which raise in the port
    (``tests/test_torch_opus_stream.py``, ``tests/test_torch_vorbis_stream.py``),
    and the methods that open an Opus decoder from its head, which build
    the owned multistream decoder through ``open_opus_core`` where the
    JAX package's ``_OpusCore`` opens libavcodec
    (``tests/test_torch_opus_multistream.py``)."""
    import importlib

    port = getattr(importlib.import_module(f"soundkit_tpu_torch.{module}"), name)
    ref = getattr(importlib.import_module(f"soundkit_tpu.{module}"), name)
    if not changed:
        assert _source(port) == _as_port(_source(ref))
        return
    got, want = _methods_but(port, ref, changed)
    assert got == want
    for m in changed:
        ref_m, port_m = _source(getattr(ref, m)), _source(getattr(port, m))
        assert "AvDecoder" in ref_m or "_av" in ref_m or \
            ("_OpusCore(" in ref_m and "open_opus_core(" in port_m)
        assert "AvDecoder" not in port_m


def test_opus_constants_of_the_stream_decoders():
    from soundkit_tpu.codecs import opus as jax_opus
    from soundkit_tpu.utils import swr
    from soundkit_tpu_torch.codecs import opus
    from soundkit_tpu_torch.utils import silk_resampler

    assert (opus._HISTORY_CAP, opus._HISTORY_KEEP, opus.OPUS_SAMPLE_RATE) == \
        (jax_opus._HISTORY_CAP, jax_opus._HISTORY_KEEP, jax_opus.OPUS_SAMPLE_RATE)
    assert silk_resampler.SILK_RESAMPLE_DELAY == swr.SILK_RESAMPLE_DELAY


def test_silk_decode_superframe_is_a_verbatim_copy():
    from soundkit_tpu.codecs import silk_native as jax_silk
    from soundkit_tpu_torch.codecs import silk_native

    assert _source(silk_native.NativeSilkDecoder.decode_superframe) == \
        _source(jax_silk.NativeSilkDecoder.decode_superframe)


@pytest.mark.parametrize("name", ["_audio_i16", "_StreamI16Adapter"])
def test_stream_adapter_is_a_verbatim_copy(name):
    from soundkit_tpu.codecs import containers
    from soundkit_tpu_torch.codecs import containers as port_containers

    assert _source(getattr(port_containers, name)) == _as_port(_source(getattr(containers, name)))


def test_opus_fleet_tail_equals_the_jax_package():
    from soundkit_tpu.models import opus_fleet_model as jax_ofm
    from soundkit_tpu_torch.models import opus_fleet_model as ofm

    port, ref = ofm.BatchedOggOpusDecoder, jax_ofm.BatchedOggOpusDecoder
    assert port.TAIL_KEEP == ref.TAIL_KEEP
    for m in ("lane_configured", "_reroute"):
        assert _source(getattr(port, m)) == _source(getattr(ref, m))
    assert _source(ofm.OpusLaneUnsupported) == _source(jax_ofm.OpusLaneUnsupported)


# ---------------------------------------------------------------------------
# the owned host codecs: GSM, AC-3, Ogg Speex, ALAC in CAF and MP4, AIFF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["demux/caf.py", "demux/mp4.py", "demux/ebml.py",
                                    "demux/mpegts.py", "demux/latm.py", "demux/audio_demux.py"])
def test_container_demuxers_are_verbatim_copies(module):
    port = (REPO / "soundkit_tpu_torch" / module).read_text()
    assert port == _as_port((REPO / "soundkit_tpu" / module).read_text())


@pytest.mark.parametrize("module,table", [("ac3_core", "ac3_tables.npz"),
                                          ("speex_core", "speex_tables.npz")])
def test_codec_cores_are_copies_but_for_their_table_path(module, table):
    """``codecs/ac3_core.py`` and ``speex_core.py`` read their table from
    the port's ``data/`` (a byte copy), where the originals read
    ``native/generated/``; the same tables come back."""
    import importlib

    port = (REPO / "soundkit_tpu_torch/codecs" / f"{module}.py").read_text()
    ref = (REPO / "soundkit_tpu/codecs" / f"{module}.py").read_text()
    old = f'        / "data"\n        / "{table}"\n'
    assert port.count(old) == 1
    assert port.replace(old, f'        / "native"\n        / "generated"\n        / "{table}"\n') == ref
    load = "_t" if module == "ac3_core" else "_tables"
    got = getattr(importlib.import_module(f"soundkit_tpu_torch.codecs.{module}"), load)()
    want = getattr(importlib.import_module(f"soundkit_tpu.codecs.{module}"), load)()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _without_docstring_note(text: str, note: str) -> str:
    """``text`` with the port's paragraph ``note`` (the one that names the
    difference) taken out of the module docstring."""
    assert text.count(note) == 1, note
    return text.replace(note, "")


def test_aiff_is_a_copy_but_for_its_device_carrying_g711_call():
    """``codecs/aiff.py``: the G.711 branch decodes through the port's
    ``codecs/g711.decode_i16`` on the decoder's device (K3), so
    ``decode_aiff_container``, ``AiffDecoder`` and ``AiffAdapter`` take and
    pass on ``device``; nothing else differs."""
    port = (REPO / "soundkit_tpu_torch/codecs/aiff.py").read_text()
    ref = _as_port((REPO / "soundkit_tpu/codecs/aiff.py").read_text())
    port = _without_docstring_note(port, """

Port: the G.711 codes decode through ``codecs/g711.decode_i16`` on the
decoder's ``device`` (K3 on one ``[1, N]`` lane, the card unless the
caller names the CPU); the rest is the JAX package's code.""")
    for got, want in (
            ('def decode_aiff_container(data: bytes, device="cuda") -> AudioData:',
             "def decode_aiff_container(data: bytes) -> AudioData:"),
            ("g711_decode_i16(law, sound, device)", "g711_decode_i16(law, sound)"),
            ('    def __init__(self, device="cuda") -> None:\n        self._buf = bytearray()\n'
             "        self._device = device\n",
             "    def __init__(self) -> None:\n        self._buf = bytearray()\n"),
            ("decode_aiff_container(data, self._device)", "decode_aiff_container(data)"),
            ('    def __init__(self, device="cuda") -> None:\n        self._dec = AiffDecoder(device)',
             "    def __init__(self) -> None:\n        self._dec = AiffDecoder()")):
        assert port.count(got) == 1, got
        port = port.replace(got, want)
    assert port == ref


def test_alac_is_a_copy_but_for_its_library():
    port = (REPO / "soundkit_tpu_torch/codecs/alac.py").read_text()
    ref = _as_port((REPO / "soundkit_tpu/codecs/alac.py").read_text())
    port = _without_docstring_note(port, """

Port: the decoder loads the port's build of ``native_src/src/alac.cpp``
(``native.alac_library``); the rest is the JAX package's code.""")
    port = port.replace("from soundkit_tpu_torch.native import alac_library\n",
                        "from soundkit_tpu_torch.native.loader import load\n")
    assert port.replace("self._lib = alac_library()", "self._lib = load()") == ref


# (module, class or function, the members that carry the named difference)
HOST_CODEC_COPIES = [
    ("codecs.telephony", "amr_nb_frame_len", None),
    ("codecs.telephony", "GsmVariant", ()),
    ("codecs.telephony", "GsmDecoder", ("__init__",)),
    ("codecs.telephony", "Ac3Decoder", ()),
    ("codecs.telephony", "_I16Adapter", ()),
    ("codecs.telephony", "make_gsm_adapter", None),
    ("codecs.telephony", "make_amr_adapter", None),
    ("codecs.telephony", "make_g729_adapter", None),
    ("codecs.telephony", "make_ac3_adapter", None),
    ("codecs.containers", "_Mp4BufferedAdapter", ("flush",)),
    ("codecs.containers", "M4aAdapter", ()),
    ("codecs.containers", "AlacAdapter", ()),
    ("codecs.containers", "make_ogg_opus_adapter", None),
    ("codecs.containers", "make_opus_stream_adapter", None),
    ("codecs.containers", "make_vorbis_adapter", None),
    ("codecs.containers", "make_speex_adapter", None),
    ("codecs.speex", "SpeexDecoder", ("__init__", "_init_decoder")),
    ("simple", "AacDeboxer", ()),
    ("simple", "AudioTrackDemuxer", ()),
]


@pytest.mark.parametrize("module,name,changed", HOST_CODEC_COPIES)
def test_host_codec_pieces_are_verbatim_copies(module, name, changed):
    """The verbatim subsets of ``codecs/telephony.py``, ``containers.py``
    and ``speex.py`` (and ``simple.AacDeboxer``, M4A walk included) equal
    the JAX package's but for their imports and the members named in the
    table: ``GsmDecoder.__init__`` loads the port's library, and the
    libavcodec branches raise ``UnsupportedFormat``
    (``tests/test_torch_host_codecs.py``, ``tests/test_torch_containers.py``)."""
    import importlib

    port = getattr(importlib.import_module(f"soundkit_tpu_torch.{module}"), name)
    ref = getattr(importlib.import_module(f"soundkit_tpu.{module}"), name)
    if not changed:
        assert _source(port) == _as_port(_source(ref))
        return
    got, want = _methods_but(port, ref, changed)
    assert got == want
    if name == "GsmDecoder":
        assert _source(port.__init__) == _as_port(_source(ref.__init__)).replace(
            "from soundkit_tpu_torch.native.loader import load",
            "from soundkit_tpu_torch.native import gsm_library").replace(
            "self._lib = load()", "self._lib = gsm_library()")
        return
    for m in changed:
        assert "AvDecoder" in _source(getattr(ref, m))
        assert "AvDecoder" not in _source(getattr(port, m))
    assert any("raise UnsupportedFormat" in _source(getattr(port, m)) for m in changed)


def test_amr_and_g729_decoders_raise_where_the_jax_package_opens_libavcodec():
    """The AMR-NB and G.729 decoders are copies but for their decoder (the
    name is the earlier slices', whose copies raised): where the JAX
    package opens ``AvDecoder("amrnb")`` / ``AvDecoder(codec_name, ...)``,
    the port opens the owned ``_G729Core`` / ``_AmrNbCore``; the framing (the 10-byte
    buffering, the magic strip, the TOC walk and its resync), the
    conversion and ``flush`` are the JAX package's code."""
    from soundkit_tpu.codecs import telephony as jax_tel
    from soundkit_tpu_torch.codecs import telephony

    assert issubclass(jax_tel.G729Decoder, jax_tel._FrameBufferedDecoder)
    assert issubclass(telephony.G729Decoder, telephony._FrameBufferedDecoder)
    swaps = {"_FrameBufferedDecoder": ('AvDecoder(codec_name, sample_rate=rate, channels=1)',
                                       '_OWNED_CORES[codec_name]()'),
             "AmrNbDecoder": ('AvDecoder("amrnb", sample_rate=8000, channels=1)',
                              '_AmrNbCore()'),
             "G729Decoder": None}
    for name, swap in swaps.items():
        want = _as_port(_source(getattr(jax_tel, name)))
        if swap:
            assert swap[0] in want
            want = want.replace(*swap)
        assert _source(getattr(telephony, name)) == want, name
    for core in (telephony._OwnedCore, telephony._G729Core, telephony._AmrNbCore):
        assert "AvDecoder(" not in _source(core)
    assert telephony.AMR_MAGIC == jax_tel.AMR_MAGIC
    assert telephony._AMR_NB_FRAME_BYTES == jax_tel._AMR_NB_FRAME_BYTES


def test_webm_adapter_is_a_copy_but_for_its_opus_decoder():
    """``codecs/containers.WebmAdapter``: where the JAX package opens
    ``AvDecoder("opus")`` on the track's OpusHead, the port builds the owned
    ``_OpusCore`` from it (a stated departure, held in
    ``tests/test_torch_container_decode.py``); the Vorbis route and the
    rest are the JAX package's code."""
    import inspect

    from soundkit_tpu.codecs import containers as jax_containers
    from soundkit_tpu_torch.codecs import containers as port_containers

    port = inspect.getsource(port_containers.WebmAdapter)
    for got, want in (
            ("""            from soundkit_tpu_torch.codecs.opus import OpusHead, open_opus_core

            try:
                head = OpusHead.parse(tr.codec_private)
            except ValueError as e:
                raise DecodingFailed(f"WebM Opus track: {e}")
            # the CodecPrivate is the whole OpusHead, a multistream table too
            self._dec = open_opus_core(head)
""", """            self._dec = AvDecoder("opus", extradata=tr.codec_private)
"""),
            ("""        outs = [self._dec.decode_packet_f32(p) for p in packets]
        pcm = np.concatenate(outs) if outs else np.zeros(0, np.float32)
        return _audio_i16(f32_to_i16(pcm), self._dec.sample_rate, self._dec.channels)""",
             """        outs = [self._dec.push(p) for p in packets]
        pcm = np.concatenate(outs) if outs else np.zeros(0, np.float32)
        return _audio_i16(f32_to_i16(pcm), self._dec.rate, self._dec.channels)"""),
            ("f32_to_i16(self._dec.flush_f32()), self._dec.sample_rate, self._dec.channels",
             "f32_to_i16(self._dec.flush()), self._dec.rate, self._dec.channels")):
        assert port.count(got) == 1, got
        port = port.replace(got, want)
    assert port == _as_port(inspect.getsource(jax_containers.WebmAdapter))


# ---------------------------------------------------------------------------
# the encode direction and the SoundKit frame format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["core/frame_header.py", "core/frame_stream.py",
                                    "core/audio_packet.py", "core/audio_content_crypto.py",
                                    "codecs/opus_enc_rc.py", "codecs/opus_hybrid_enc.py"])
def test_encode_and_frame_modules_are_verbatim_copies(module):
    port = (REPO / "soundkit_tpu_torch" / module).read_text()
    assert port == _as_port((REPO / "soundkit_tpu" / module).read_text())


def test_crypto_is_a_copy_but_for_its_lazy_import():
    """``core/crypto.py`` imports ``cryptography`` where a cipher is made
    (``_aead_class``, which names the package when it is missing) and where
    it decrypts, not at the module's top."""
    port = (REPO / "soundkit_tpu_torch/core/crypto.py").read_text()
    ref = (REPO / "soundkit_tpu/core/crypto.py").read_text()
    port = _without_docstring_note(port, """

Port: the ``cryptography`` package is imported where a cipher is made or
used, not when the module loads, so the error types, the constants and
``key_from_decimal`` (and the modules above them: the frame stream, the
simple API) import without it; a cipher made without it raises an
``ImportError`` that names the package. The rest is the JAX package's
code.""")
    for got, want in (
            ("from __future__ import annotations\n\nKEY_BYTES",
             "from __future__ import annotations\n\nfrom cryptography.exceptions import InvalidTag\n"
             "from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305\n\n"
             "KEY_BYTES"),
            ('''def _aead_class():
    try:
        from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    except ImportError as e:
        raise ImportError("ChaCha20-Poly1305 needs the 'cryptography' package, which is not "
                          f"installed ({e})") from e
    return ChaCha20Poly1305


''', ""),
            ("self._aead = _aead_class()(bytes(key))", "self._aead = ChaCha20Poly1305(bytes(key))"),
            ("        from cryptography.exceptions import InvalidTag\n\n", "")):
        assert port.count(got) == 1, got
        port = port.replace(got, want)
    assert port == ref


def test_opus_celt_enc_is_a_copy_but_for_its_native_fallback():
    port = (REPO / "soundkit_tpu_torch/codecs/opus_celt_enc.py").read_text()
    ref = _as_port((REPO / "soundkit_tpu/codecs/opus_celt_enc.py").read_text())
    port = _without_docstring_note(port, """

Port: ``OpusCeltEncoder(native=True)`` loads the port's build of
``native_src/src/celt_parse.cpp`` (``codecs/celt_native.NativeCeltEncoder``)
and raises when it cannot, where the JAX package falls back to the Python
encoder; ``native=False`` chooses the Python encoder. The rest is the JAX
package's code.""")
    got = '''        # encode backend: the C++ port (native_src/src/celt_parse.cpp
        # skt_celt_enc_frame, byte-identical to the Python encoder and
        # ~100x faster); a library that fails to build or load raises
        self._native = None
        if native:
            from soundkit_tpu_torch.codecs.celt_native import (
                NativeCeltEncoder,
            )

            self._native = NativeCeltEncoder(channels)
'''
    want = '''        # encode backend: the C++ port (native/src/celt_parse.cpp
        # skt_celt_enc_frame, byte-identical to the Python encoder and
        # ~100x faster) when the toolchain is present
        self._native = None
        if native:
            try:
                from soundkit_tpu_torch.codecs.celt_native import (
                    NativeCeltEncoder,
                )

                self._native = NativeCeltEncoder(channels)
            except Exception:
                self._native = None
'''
    assert port.count(got) == 1
    assert port.replace(got, want) == ref


def test_opus_silk_enc_is_a_copy_but_for_its_native_choice():
    port = (REPO / "soundkit_tpu_torch/codecs/opus_silk_enc.py").read_text()
    ref = _as_port((REPO / "soundkit_tpu/codecs/opus_silk_enc.py").read_text())
    port = _without_docstring_note(port, """

Port: ``OpusSilkEncoder`` takes ``native`` (default True), as
``OpusCeltEncoder`` does: True loads the port's build of
``native_src/src/silk_parse.cpp`` (``codecs/silk_native.NativeSilkEncoder``)
and raises when it cannot, where the JAX package falls back to the Python
encoder; False chooses the Python encoder. The rest is the JAX package's
code.""")
    for got, want in (
            ("                 channels: int = 1, native: bool = True):",
             "                 channels: int = 1):"),
            ('''        # native frame encoder (byte-identical C++ port); a library
        # that fails to build or load raises
        self._native = None
        if native:
            from soundkit_tpu_torch.codecs.silk_native import NativeSilkEncoder
            self._native = NativeSilkEncoder(bw, channels)
''', '''        # native frame encoder (byte-identical C++ port); falls back
        # to the Python encoder when the library is unavailable
        self._native = None
        try:
            from soundkit_tpu_torch.codecs.silk_native import NativeSilkEncoder
            self._native = NativeSilkEncoder(bw, channels)
        except Exception:
            self._native = None
''')):
        assert port.count(got) == 1, got
        port = port.replace(got, want)
    assert port == ref


def test_encoders_is_a_copy_but_for_its_libavcodec_encoder():
    """``codecs/encoders.py``: ``AvEncoder`` raises ``EncodeError`` at
    construction (and so ``AacEncoder``, ``Mp3Encoder`` and ``OpusEncoder``'s
    libopus route, whose code is the JAX package's); no native loader."""
    import inspect

    from soundkit_tpu.codecs import encoders as jax_encoders
    from soundkit_tpu_torch.codecs import encoders

    port = (REPO / "soundkit_tpu_torch/codecs/encoders.py").read_text()
    ref = _as_port((REPO / "soundkit_tpu/codecs/encoders.py").read_text())
    port = _without_docstring_note(port, """

Port: the libavcodec encoder ``AvEncoder`` raises ``EncodeError`` at
construction (the port builds no libavcodec), and with it ``AacEncoder``,
``Mp3Encoder`` and ``OpusEncoder``'s libopus route (another rate than
48 kHz, or ``backend="libopus"``). The owned encoders (``FlacEncoder``,
``OpusEncoder``'s CELT, SILK and hybrid routes) and ``AudioEncoder`` are
the JAX package's code.""")
    port = port.replace(inspect.getsource(encoders.AvEncoder), inspect.getsource(jax_encoders.AvEncoder))
    port = port.replace("import struct\n", "import ctypes\nimport struct\n", 1)
    port = port.replace("from soundkit_tpu_torch.core.wav import WavStreamProcessor\n",
                        "from soundkit_tpu_torch.core.wav import WavStreamProcessor\n"
                        "from soundkit_tpu_torch.native.loader import load\n")
    assert port == ref
    assert "raise EncodeError" in inspect.getsource(encoders.AvEncoder.__init__)
    assert not hasattr(encoders, "ctypes") and not hasattr(encoders, "load")


ENCODE_COPIES = [
    ("codecs.celt_native", "NativeCeltEncoder"),
    ("codecs.silk_native", "NativeSilkEncoder"),
    ("demux.ogg", "_packet_samples_48k"),
    ("demux.ogg", "OggOpusWriter"),
    ("simple", "FlacEncoder"),
    ("simple", "OpusEncoder"),
    ("simple", "AudioContentCipher"),
    ("simple", "SoundKitFrameDecoder"),
    ("simple", "AudioContentKeyUnwrapper"),
]


@pytest.mark.parametrize("module,name", ENCODE_COPIES)
def test_encode_pieces_are_verbatim_copies(module, name):
    import importlib

    port = getattr(importlib.import_module(f"soundkit_tpu_torch.{module}"), name)
    ref = getattr(importlib.import_module(f"soundkit_tpu.{module}"), name)
    assert _source(port) == _as_port(_source(ref))


def test_celt_encoder_binding_types_the_jax_packages_signature():
    """``native.opus_library`` types ``skt_celt_enc_frame`` as the JAX
    package's ``codecs/celt_native._lib`` does."""
    from soundkit_tpu.codecs import celt_native as jax_celt
    from soundkit_tpu_torch.native import opus_library

    port, ref = opus_library().skt_celt_enc_frame, jax_celt._lib().skt_celt_enc_frame
    assert port.restype == ref.restype and list(port.argtypes) == list(ref.argtypes)


# ---------------------------------------------------------------------------
# the batch parses, the host Opus models, the FLAC split walks, the quality
# utilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["parse_many", "parse_many_q", "parse_many_cont"])
def test_celt_batch_parses_are_verbatim_copies(method):
    from soundkit_tpu.codecs import celt_native as jax_celt
    from soundkit_tpu_torch.codecs import celt_native

    assert _source(getattr(celt_native.NativeCeltBatch, method)) == \
        _source(getattr(jax_celt.NativeCeltBatch, method))


def test_host_silk_decoder_is_a_copy_but_for_its_resampler():
    """``BatchedSilkDecoder`` resamples through the port's
    ``utils/silk_resampler`` where the JAX package opens libswresample."""
    from soundkit_tpu.models import opus_batch as jax_ob
    from soundkit_tpu_torch.models import opus_batch

    want = _as_port(_source(jax_ob.BatchedSilkDecoder)).replace(
        "from soundkit_tpu_torch.utils.swr import SilkResampler",
        "from soundkit_tpu_torch.utils.silk_resampler import SilkResampler")
    assert _source(opus_batch.BatchedSilkDecoder) == want


def test_opus_batch_decoder_is_a_copy_but_for_its_owned_decoder():
    """``BatchedOpusDecoder`` opens an owned ``_OpusCore`` a lane where the
    JAX package opens libavcodec: those lines and the class's docstring
    differ, nothing else."""
    from soundkit_tpu.models import opus_batch as jax_ob
    from soundkit_tpu_torch.models import opus_batch

    port, ref = opus_batch.BatchedOpusDecoder, jax_ob.BatchedOpusDecoder
    want = _source(ref)
    for old, new in (
            ("so\n        # avcodec honors", "so the\n        # decoder honors"),
            ("List[Optional[AvDecoder]]", "List[Optional[_OpusCore]]"),
            ("-> AvDecoder:", "-> _OpusCore:"),
            ('AvDecoder("opus", extradata=self._extradata[b])',
             "_raw_wire_core(self._extradata[b])"),
            ("pcm = dec.push(pkt)", "pcm = dec.decode_packet_f32(pkt)")):
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    got = _source(port).replace(f'    """{port.__doc__}"""\n\n', "", 1)
    assert got == want
    assert _function_source(opus_batch, "_default_extradata") == \
        _function_source(jax_ob, "_default_extradata")
    assert port.FRAME == ref.FRAME == 960


@pytest.mark.parametrize("name", ["FlacPartsStream", "FlacSegsStream"])
def test_flac_split_walks_are_copies_but_for_their_library(name):
    from soundkit_tpu.codecs import flac as jax_flac
    from soundkit_tpu_torch.codecs import flac

    want = _source(getattr(jax_flac, name)).replace("self._lib = load()",
                                                    "self._lib = flac_library()")
    assert _source(getattr(flac, name)) == want


@pytest.mark.parametrize("module", ["utils/quality.py", "utils/waveform.py",
                                    "utils/test_utils.py"])
def test_quality_utilities_are_verbatim_copies(module):
    port = (REPO / "soundkit_tpu_torch" / module).read_text()
    assert port == (REPO / "soundkit_tpu" / module).read_text()


def test_models_package_exports_the_jax_packages_names():
    import soundkit_tpu.models as jax_models
    import soundkit_tpu_torch.models as models

    assert models.__all__ == jax_models.__all__
    for name in models.__all__:
        assert getattr(models, name).__module__ == \
            getattr(jax_models, name).__module__.replace("soundkit_tpu.", "soundkit_tpu_torch.")
