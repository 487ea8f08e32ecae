"""Port parity of MPEG audio Layer I / II on the CPU: the port's owned
host decoder (``codecs/mpa_layer12.py``, reached through ``Mp3Decoder``)
against the JAX package's ``Mp3Decoder``, which hands these streams to
libavcodec, on the committed clips of ``tests/data/torch_port/mpa``
(``tools/mpa_fixtures.py``): MPEG-1, MPEG-2 LSF and MPEG-2.5, Layer I and
II, mono, stereo, joint stereo at every bound, dual channel, with and
without CRC, padded frames.

Bars: the same length, rate and channels, float32 SNR >= 100 dB a stream
(libavcodec synthesizes in float32: 115.31-127.28 dB measured by
``torch_port_helpers.mpa_libavcodec_snr``), int16 within 1
LSB. Then chunk invariance (1-byte, 313-byte and whole pushes give the
same PCM, each push as many samples as the JAX package's), framing
(ID3v2 prefix, junk and zeros between frames, truncated tails), each
entry point that reaches ``Mp3Decoder``, the fleet (which decodes these
streams in neither package), auto-detection (Layer III only in both) and
the committed tables against a fresh extraction from ``libavcodec.a``."""
from pathlib import Path

import numpy as np
import pytest

from soundkit_tpu.codecs import mp3 as jax_mp3
from soundkit_tpu.demux import detect as jax_detect
from soundkit_tpu.pipeline import adapters as jax_adapters
from soundkit_tpu.pipeline import decode_pipeline as jax_dp
from soundkit_tpu import simple as jax_simple
from soundkit_tpu_torch import simple
from soundkit_tpu_torch.codecs import mp3
from soundkit_tpu_torch.codecs import mpa_layer12 as mpa
from soundkit_tpu_torch.core.audio_types import AudioData
from soundkit_tpu_torch.demux import detect
from soundkit_tpu_torch.pipeline import adapters
from soundkit_tpu_torch.pipeline import decode_pipeline as dp
from soundkit_tpu_torch.pipeline.output_options import UnsupportedFormat
from soundkit_tpu_torch.tools import extract_mpa_tables
from soundkit_tpu_torch.tools import mpa_fixtures as mf

from torch_port_helpers import jax_mpa_f32, snr_db

INDEX = mf.load_index()
CLIPS = sorted(INDEX)
# one of each kind for the slower cases: Layer II stereo, LSF mono, Layer I
# joint stereo, Layer II with CRC and padding
SOME = ("l2_48_stereo_192", "l2_lsf22_mono_64", "l1_48_joint_256", "l2_44_stereo_crc_128")


def _port(data: bytes, chunk: int = 0):
    """The port's decode: (PCM, samples out of each push, rate, channels)."""
    dec = mp3.Mp3Decoder(device="cpu")
    parts = [data] if not chunk else [data[i:i + chunk] for i in range(0, len(data), chunk)]
    outs = [dec.decode_f32(p) for p in parts] + [dec.flush_f32()]
    return np.concatenate(outs), [len(o) for o in outs], dec.sample_rate, dec.channels


def _jax(data: bytes, chunk: int = 0):
    dec = jax_mp3.Mp3Decoder()
    parts = [data] if not chunk else [data[i:i + chunk] for i in range(0, len(data), chunk)]
    outs = [dec.decode_f32(p) for p in parts] + [dec.flush_f32()]
    return np.concatenate(outs), [len(o) for o in outs], dec.sample_rate, dec.channels


def _assert_close(got: np.ndarray, want: np.ndarray) -> float:
    assert got.shape == want.shape and got.dtype == np.float32
    if not np.any(want):
        np.testing.assert_array_equal(got, want)
        return float("inf")
    snr = snr_db(got, want)
    assert snr >= 100.0, snr
    lsb = np.abs(mp3.f32_to_i16(got).astype(np.int32) - jax_mp3.f32_to_i16(want).astype(np.int32))
    assert lsb.max() <= 1
    return snr


# ---------------------------------------------------------------------------
# the clips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CLIPS)
def test_clip_decodes_like_the_jax_package(name):
    """Whole stream, then flush: length, rate, channels, >= 100 dB, 1 LSB;
    the clip's bytes and the JAX package's PCM as the index records them."""
    e = INDEX[name]
    data = mf.clip_bytes(name)
    assert mf.sha256(data) == e["sha256"]
    want, _, rate, ch = _jax(data)
    assert want.size == e["samples"] and mf.sha256(want.tobytes()) == e["pcm_sha256"]
    got, _, port_rate, port_ch = _port(data)
    assert (port_rate, port_ch) == (rate, ch) == (e["rate"], e["channels"])
    _assert_close(got, want)
    assert len(mf.split_frames(data)) == e["frames"]


def test_clips_cover_the_layers_versions_and_modes():
    kinds = {(e["layer"], e["version"], e["mode"]) for e in INDEX.values()}
    for layer in (1, 2):
        assert {v for lay, v, _ in kinds if lay == layer} >= {"1", "2"}
        assert {m for lay, _, m in kinds if lay == layer} >= {"stereo", "joint"}
    assert {m for _, _, m in kinds} == {"stereo", "joint", "dual", "mono"}
    assert any(v == "2.5" for _, v, _ in kinds)
    assert any(e.get("crc") for e in INDEX.values())
    assert {e["origin"] for e in INDEX.values()} == {"mp2", "libtwolame", "writer"}
    # the four MPEG-1 Layer II allocation tables and the LSF one
    tables = {mpa.select_table(e["bit_rate"] // 1000, e["channels"], e["rate"],
                               int(e["version"] != "1"))
              for e in INDEX.values() if e["layer"] == 2}
    assert tables == {0, 1, 2, 3, 4}
    # joint stereo: every bound, in Layer I and in Layer II
    for layer in (1, 2):
        exts = set()
        for name, e in INDEX.items():
            if e["layer"] == layer and e["mode"] == "joint":
                exts |= {(f[3] >> 4) & 3 for f in mf.split_frames(mf.clip_bytes(name))}
        assert exts == {0, 1, 2, 3}
    # padded frames
    padded = [f for name in INDEX for f in mf.split_frames(mf.clip_bytes(name)) if f[2] & 2]
    assert padded


def test_smoke_reference_pcm_is_the_jax_decode():
    """``reference_pcm.npz`` (what ``chip_smoke.py`` holds the card's
    machine to, where no JAX runs) is the JAX package's PCM of its clips."""
    for name in mf.SMOKE:
        ref = mf.reference_pcm(name)
        np.testing.assert_array_equal(ref, jax_mpa_f32(mf.clip_bytes(name))[0])


@pytest.mark.parametrize("name", SOME)
def test_chunked_pushes_decode_alike(name):
    """1-byte, 313-byte and whole pushes give the same PCM, and each push
    returns as many samples as the JAX package's same push: a frame comes
    out with its last byte, as libavcodec's parser emits it."""
    data = mf.clip_bytes(name)
    whole = _port(data)[0]
    for chunk in (1, 313):
        got, sizes, _, _ = _port(data, chunk)
        np.testing.assert_array_equal(got, whole)
        assert sizes == _jax(data, chunk)[1]


def test_a_long_stream_starts_with_its_clip():
    """:func:`mpa_fixtures.long_stream` repeats frames: its decode begins
    with the clip's."""
    data, seconds = mf.long_stream("l1_48_stereo_384", 0.5)
    e = INDEX["l1_48_stereo_384"]
    got = _port(data)[0]
    assert got.size == round(seconds * e["rate"] * e["channels"])
    np.testing.assert_array_equal(got[:e["samples"]], _port(mf.clip_bytes("l1_48_stereo_384"))[0])


# ---------------------------------------------------------------------------
# framing: what libavcodec's parser and decode_frame do with extra bytes
# ---------------------------------------------------------------------------

ID3 = b"ID3\x04\x00\x00\x00\x00\x02\x00" + bytes(range(1, 200)) + bytes(56)


def _framing_cases(data: bytes) -> dict:
    fr = mf.split_frames(data)
    last = len(fr[-1])
    return {
        "id3v2_prefix": ID3 + data,  # junk before the first frame costs it
        "zero_prefix": bytes(300) + data,  # zeros are skipped
        "junk_between": b"".join(f + (b"junk!" if i % 3 == 1 else b"") for i, f in enumerate(fr)),
        "zeros_between": b"".join(f + (bytes(7) if i % 2 else b"") for i, f in enumerate(fr)),
        "false_sync_between": fr[0] + b"\xff\xfb\x00" + b"".join(fr[1:]),
        "cut_mid_frame": data[:-last // 2],  # decoded at flush, zeros past the end
        "cut_in_header": data[:-last + 2],
        "cut_after_header": data[:-last + 6],
        "id3v1_tail": data + b"TAG" + bytes(125),
        "short_tail": data + b"abc",
    }


@pytest.mark.parametrize("case", sorted(_framing_cases(b"\xff\xfd\xa4\x04" + bytes(572))))
@pytest.mark.parametrize("name", ["l2_48_stereo_192", "l1_44_mono_crc"])
def test_framing_like_the_jax_package(name, case):
    """The whole stream's PCM, whole and in 313-byte pushes, against the
    JAX package's on the same bytes (the same frames kept and lost)."""
    data = _framing_cases(mf.clip_bytes(name))[case]
    want = _jax(data)[0]
    if case in ("id3v2_prefix", "junk_between", "false_sync_between", "cut_in_header"):
        assert want.size < INDEX[name]["samples"]  # a frame is lost in both
    for chunk in (0, 313):
        _assert_close(_port(data, chunk)[0], want)


def test_header_parse_takes_what_the_sniff_takes():
    """Every header the sniff and the framer accept parses, and the frame
    sizes follow the standard's formulas."""
    h = mpa.parse_header(bytes([0xFF, 0xFD, 0xA4, 0x04]))  # MPEG-1 L2 192k 48k, no CRC
    assert (h.layer, h.lsf, h.rate, h.bitrate, h.frame_size, h.crc, h.channels) == \
        (2, 0, 48000, 192, 576, False, 2)
    h = mpa.parse_header(bytes([0xFF, 0xFE, 0x92, 0xC0]))  # MPEG-1 L1 288k 44.1k padded mono CRC
    assert (h.layer, h.frame_size, h.crc, h.channels) == (1, (288 * 12000 // 44100 + 1) * 4, True, 1)
    h = mpa.parse_header(bytes([0xFF, 0xE5, 0x44, 0x00]))  # MPEG-2.5 L2 32k 12k
    assert (h.lsf, h.mpeg25, h.rate, h.frame_size) == (1, 1, 12000, 32 * 144000 // 12000)
    for bad in (b"\xff\xfd\x04\x04", b"\xff\xfd\xf4\x04", b"\xff\xfd\xac\x04", b"\xff\xf9\xa4\x04",
                b"\xff\xf1\xa4\x04", b"\xfe\xfd\xa4\x04"):
        assert mpa.parse_header(bad) is None  # free format, bad rate / bitrate / version / layer


def test_unscale_is_the_spec_formula_at_23_bits():
    """The integer unscale (libavcodec's) lies within 2**-22 of the
    standard's ``2 (code - steps // 2) / steps * 2 ** (1 - sf / 3)``."""
    sf = np.arange(63)[:, None]
    for bits in range(2, 17):
        steps = (1 << bits) - 1
        code = np.arange(0, steps, max(1, steps // 61))[None, :]
        got = mpa._unscale(code - steps // 2, bits, steps, False, sf)
        exact = 2.0 * (code - steps // 2) / steps * 2.0 ** (1 - sf / 3.0)
        assert np.abs(got - exact).max() <= 2.0 ** -22
    for steps in (3, 5, 9):
        code = np.arange(steps)[None, :]
        got = mpa._unscale(code - steps // 2, 0, steps, True, sf)
        exact = 2.0 * (code - steps // 2) / steps * 2.0 ** (1 - sf / 3.0)
        assert np.abs(got - exact).max() <= 2.0 ** -22


# ---------------------------------------------------------------------------
# the entry points that reach Mp3Decoder
# ---------------------------------------------------------------------------

def _fields(outs):
    return [(o.sampling_rate, o.channel_count, o.bits_per_sample, len(o.data))
            if hasattr(o, "sampling_rate") else type(o).__name__ for o in outs]


def _assert_same_audio(got, want):
    assert _fields(got) == _fields(want) and got
    a = np.frombuffer(b"".join(o.data for o in got), "<i2").astype(np.int32)
    b = np.frombuffer(b"".join(o.data for o in want), "<i2").astype(np.int32)
    assert np.abs(a - b).max() <= 1


def _adapter_run(adapter, data: bytes, chunk: int = 997):
    outs = [o for i in range(0, len(data), chunk) for o in adapter.process(data[i:i + chunk])]
    return outs + adapter.flush()


@pytest.mark.parametrize("make", ["Mp3Adapter", "make_mp3_adapter"])
def test_adapters_decode_layer2(make):
    data = mf.clip_bytes("l2_44_stereo_192")
    if make == "Mp3Adapter":
        port, ref = mp3.Mp3Adapter("cpu"), jax_mp3.Mp3Adapter()
    else:
        port, ref = adapters.make_mp3_adapter("cpu"), jax_adapters.make_mp3_adapter()
    _assert_same_audio(_adapter_run(port, data), _adapter_run(ref, data))


def test_spawn_mp3_decodes_layer2():
    """The threaded ``DecodePipeline.spawn_mp3`` against the JAX package's."""
    data = mf.clip_bytes("l2_lsf24_stereo_96") * 3

    def run(handle):
        drained = []
        for i in range(0, len(data), 1024):
            handle.send_blocking(data[i:i + 1024], drained)
        handle.send_blocking(b"", drained)
        return drained + handle.recv_all(timeout=60)

    got = run(dp.DecodePipeline.spawn_mp3(device="cpu"))
    _assert_same_audio(got, run(jax_dp.DecodePipeline.spawn_mp3()))
    assert all(isinstance(o, AudioData) for o in got)


def test_music_decoder_new_with_format_mp3_decodes_layer1():
    data = mf.clip_bytes("l1_lsf24_stereo_128")
    dec = simple.MusicDecoder.new_with_format("mp3", device="cpu")
    ref = jax_simple.MusicDecoder.new_with_format("mp3")
    got = [f for i in range(0, len(data), 500) for f in dec.push(data[i:i + 500])] + dec.flush()
    want = [f for i in range(0, len(data), 500) for f in ref.push(data[i:i + 500])] + ref.flush()
    assert [(f.sample_rate, f.channels, f.bits, len(f.pcm)) for f in got] == \
        [(f.sample_rate, f.channels, f.bits, len(f.pcm)) for f in want] and got
    a = np.frombuffer(b"".join(f.pcm for f in got), "<i2").astype(np.int32)
    b = np.frombuffer(b"".join(f.pcm for f in want), "<i2").astype(np.int32)
    assert np.abs(a - b).max() <= 1


def test_av_backend_still_raises():
    with pytest.raises(UnsupportedFormat, match="libavcodec"):
        mp3.Mp3Decoder(backend="av", device="cpu")


# ---------------------------------------------------------------------------
# detection and the fleet: Layer I / II is not detected in either package
# ---------------------------------------------------------------------------

def test_auto_detection_stays_layer3_only():
    for name in CLIPS:
        data = mf.clip_bytes(name) * 4
        assert detect.detect_audio(data).name == jax_detect.detect_audio(data).name == "UNKNOWN"


def test_fleet_outcome_equals_the_jax_package():
    """A Layer II stream pushed to ``StreamFleet`` detected, with kind
    "mp3" onto a lane, and with kind "mp3" when the group is full: neither
    package decodes it (detection fails; the lane's Layer III parser finds
    no granule) and neither raises."""
    from soundkit_tpu.models.fleet import StreamFleet as JaxFleet
    from soundkit_tpu_torch.models.fleet import StreamFleet

    data, _ = mf.long_stream("l2_48_stereo_192", 1.5)

    def run(fleet):
        fleet.push("detected", data)
        fleet.push("lane", data, kind="mp3")
        fleet.push("overflow", data, kind="mp3")  # the one-lane group is full
        for sid in ("detected", "lane", "overflow"):
            fleet.end_stream(sid)
        got = {}
        for _ in range(3):
            for sid, pcm in fleet.collect().items():
                got.setdefault(sid, []).append(np.asarray(pcm).shape)
        return got, [fleet.sample_rate(s) for s in ("detected", "lane", "overflow")]

    port = run(StreamFleet(1, device="cpu"))
    assert port == run(JaxFleet(1)) == ({}, [None, None, None])


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

def test_committed_tables_equal_a_fresh_extraction():
    if not Path(extract_mpa_tables.ARCHIVE).is_file():
        pytest.skip(f"no {extract_mpa_tables.ARCHIVE} to extract from")
    fresh = extract_mpa_tables.extract()
    with np.load(Path(mpa.__file__).resolve().parents[1] / "data" / "mpa_tables.npz") as z:
        assert sorted(z.files) == sorted(fresh)
        for k in z.files:
            np.testing.assert_array_equal(z[k], fresh[k])
    assert list(fresh["sblimit"]) == [27, 30, 8, 12, 30]


def test_fixtures_equal_a_regeneration(tmp_path):
    """The generator (on the test side: the JAX package's ``AvEncoder``
    and libavcodec decode, and the seeded frame writer) makes the
    committed clips and index byte for byte, and the same reference PCM."""
    from torch_port_helpers import generate_mpa_fixtures

    generate_mpa_fixtures(tmp_path)
    names = sorted(p.name for p in mf.FIXTURE_DIR.iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == names
    for name in names:
        if name.endswith(".npz"):
            with np.load(tmp_path / name) as got, np.load(mf.FIXTURE_DIR / name) as want:
                assert sorted(got.files) == sorted(want.files) == sorted(mf.SMOKE)
                for k in want.files:
                    np.testing.assert_array_equal(got[k], want[k])
            continue
        assert (tmp_path / name).read_bytes() == (mf.FIXTURE_DIR / name).read_bytes(), name
