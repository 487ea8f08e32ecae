"""Port parity: the port's ``StreamDecoder`` / ``DecodePipeline`` and
simple API against the JAX package's on the CPU (``device="cpu"``).

The output lists are equal: each ``AudioData``'s bytes, rate, channels
and bits, each error by its class (MP3 within 1 LSB in its int16
bytes, its bar in ``tests/test_torch_streaming_codecs.py``; Opus SILK
and hybrid within 1 LSB, the port's resampler rounding its sums
otherwise than libswresample). Formats by autodetect (WAV, FLAC, MP3,
AAC, Ogg Opus, raw Opus, Ogg Vorbis) and by explicit spawn (raw PCM,
G.711, G.722, G.726, the Opus and Vorbis spawns and the owned host
codecs' spawns, whose detection ``tests/test_torch_host_codecs.py``
holds), chunk invariance, ``DecodeOptions``, the error cases,
the threaded handle against the synchronous core, and a device fault
that must reach the caller."""
from pathlib import Path

import numpy as np
import pytest

from soundkit_tpu import simple as jax_simple
from soundkit_tpu.codecs.g711 import G711Law as JaxLaw
from soundkit_tpu.codecs.g726 import G726Packing as JaxPacking
from soundkit_tpu.codecs.g726 import G726Rate as JaxRate
from soundkit_tpu.core.audio_types import AudioData as JaxAudioData
from soundkit_tpu.core.raw_pcm import RawPcmFormat as JaxRawPcmFormat
from soundkit_tpu.pipeline import decode_pipeline as jax_dp
from soundkit_tpu.pipeline.output_options import DecodeOptions as JaxOptions
from soundkit_tpu_torch import simple
from soundkit_tpu_torch.codecs.aac import AacAdtsAdapter
from soundkit_tpu_torch.codecs.g711 import G711Law
from soundkit_tpu_torch.codecs.g726 import G726Packing, G726Rate
from soundkit_tpu_torch.codecs.mp3 import Mp3Adapter
from soundkit_tpu_torch.core.audio_types import AudioData, PcmData
from soundkit_tpu_torch.core.raw_pcm import RawPcmFormat
from soundkit_tpu_torch.core.wav import generate_wav_buffer
from soundkit_tpu_torch.pipeline import decode_pipeline as dp
from soundkit_tpu_torch.pipeline.output_options import (DecodeError, DecodeOptions,
                                                       FormatDetectionFailed, InputBufferFull,
                                                       NoAudioDecoded, UnsupportedFormat)
from soundkit_tpu_torch.tools import telephony_fixtures as tfx
from soundkit_tpu_torch.utils.device import KernelLaunchError

DATA = Path(__file__).resolve().parent / "data" / "torch_port"
AUDIO = (AudioData, JaxAudioData)


def _wav() -> bytes:
    rng = np.random.default_rng(20)
    t = np.arange(24000) / 24000.0
    left = 12000 * np.sin(2 * np.pi * 440 * t) + rng.normal(0, 300, t.size)
    right = 9000 * np.sin(2 * np.pi * 660 * t)
    return generate_wav_buffer(PcmData.i16([left.astype(np.int16), right.astype(np.int16)]), 24000)


def _stream(fmt: str) -> bytes:
    if fmt == "wav":
        return _wav()
    if fmt == "flac":
        return (DATA / "flac" / "stereo16.flac").read_bytes()
    if fmt == "mp3":
        return (DATA / "mp3" / "lsf22.mp3").read_bytes()
    return (DATA / "sweep_pan.aac").read_bytes()[:30000]


def _drive(core, data: bytes, chunk: int):
    outs = []
    for i in range(0, len(data), chunk):
        outs.extend(core.process(data[i:i + chunk]))
    return outs + core.process(b"")


def _summary(outs):
    return [("audio", o.sampling_rate, o.channel_count, o.bits_per_sample, o.audio_format.value,
             len(o.data)) if isinstance(o, AUDIO) else ("error", type(o).__name__)
            for o in outs]


def _pcm(outs, bits: int = 16) -> np.ndarray:
    raw = b"".join(o.data for o in outs if isinstance(o, AudioData))
    return np.frombuffer(raw, dtype=np.int16 if bits == 16 else np.uint8)


def _assert_same_outputs(got, want, lsb: int = 0):
    assert _summary(got) == _summary(want)
    assert any(isinstance(o, AudioData) for o in got)
    for g, w in zip(got, want):
        if not isinstance(g, AUDIO):
            continue
        if lsb:
            a, b = np.frombuffer(g.data, "<i2"), np.frombuffer(w.data, "<i2")
            assert np.abs(a.astype(np.int32) - b).max() <= lsb
        else:
            assert g.data == w.data


@pytest.mark.parametrize("fmt", ["wav", "flac", "mp3", "aac"])
@pytest.mark.parametrize("chunk", [313, 4096])
def test_autodetect_matches_jax(fmt, chunk):
    data = _stream(fmt)
    got = _drive(dp.StreamDecoder(device="cpu"), data, chunk)
    want = _drive(jax_dp.StreamDecoder(), data, chunk)
    _assert_same_outputs(got, want, lsb=1 if fmt == "mp3" else 0)
    assert not any(isinstance(o, DecodeError) for o in got)


def _explicit(kind: str):
    """(port adapter, JAX adapter, bytes) for an explicit format."""
    if kind == "raw_pcm":
        pcm = tfx.pcm_clips(8000)[0][:6000].astype("<i2").tobytes()
        return (dp.RawPcmAdapter(RawPcmFormat.linear16(8000, 2)),
                jax_dp.RawPcmAdapter(JaxRawPcmFormat.linear16(8000, 2)), pcm)
    if kind in ("g711_mulaw", "g711_alaw"):
        law = G711Law.MU_LAW if kind == "g711_mulaw" else G711Law.A_LAW
        jlaw = JaxLaw.MU_LAW if kind == "g711_mulaw" else JaxLaw.A_LAW
        return (dp.G711Adapter(law, 8000, 1, "cpu"), jax_dp.G711Adapter(jlaw, 8000, 1),
                tfx.load_clips(kind)[2][:6000])
    if kind == "g722":
        return dp.G722Adapter("cpu"), jax_dp.G722Adapter(), tfx.load_clips("g722")[1][:700]
    bits = {"g726_16": 2, "g726_40": 5}[kind]
    rate, jrate = G726Rate(bits), JaxRate(bits)
    return (dp.G726Adapter(rate, G726Packing.RIGHT, "cpu"),
            jax_dp.G726Adapter(jrate, JaxPacking.RIGHT),
            tfx.load_clips(kind)[4][:bits * 100 + 3])


@pytest.mark.parametrize("kind", ["raw_pcm", "g711_mulaw", "g711_alaw", "g722", "g726_16",
                                  "g726_40"])
def test_explicit_formats_match_jax(kind):
    port, ref, data = _explicit(kind)
    got = _drive(dp.StreamDecoder(DecodeOptions(), port, "cpu"), data, 137)
    want = _drive(jax_dp.StreamDecoder(JaxOptions(), ref), data, 137)
    _assert_same_outputs(got, want)
    errors = [s for s in _summary(got) if s[0] == "error"]
    # G.726 at 40 kbit/s ends on a partial group of 5 bytes; at 16 a group is a byte
    assert errors == ([("error", "DecodingFailed")] if kind == "g726_40" else [])


@pytest.mark.parametrize("fmt", ["wav", "flac", "mp3", "aac"])
def test_chunk_invariance(fmt):
    data = _stream(fmt)[:40000]
    runs = [_pcm(_drive(dp.StreamDecoder(device="cpu"), data, c)) for c in (1 << 20, 313, 137)]
    np.testing.assert_array_equal(runs[1], runs[0])
    np.testing.assert_array_equal(runs[2], runs[0])
    # a 1-byte prefix: detection waits, then replays the buffered bytes
    core = dp.StreamDecoder(device="cpu")
    outs = [o for b in data[:64] for o in core.process(bytes([b]))]
    outs += _drive(core, data[64:], 4096)
    np.testing.assert_array_equal(_pcm(outs), runs[0])


OPTIONS = {
    "16k_mono_16": (DecodeOptions(16, 16000, 1), JaxOptions(16, 16000, 1)),
    "bits_24": (DecodeOptions(output_bits_per_sample=24), JaxOptions(output_bits_per_sample=24)),
}


@pytest.mark.parametrize("opt", list(OPTIONS))
@pytest.mark.parametrize("fmt", ["wav", "aac"])
def test_decode_options_match_jax(opt, fmt):
    port_opt, jax_opt = OPTIONS[opt]
    data = _stream(fmt)[:30000]
    got = _drive(dp.StreamDecoder(port_opt, device="cpu"), data, 4096)
    want = _drive(jax_dp.StreamDecoder(jax_opt), data, 4096)
    _assert_same_outputs(got, want)
    audio = [o for o in got if isinstance(o, AudioData)]
    if opt == "16k_mono_16":
        assert {(a.sampling_rate, a.channel_count, a.bits_per_sample) for a in audio} == \
            {(16000, 1, 16)}
    else:
        assert {a.bits_per_sample for a in audio} == {24}


def test_junk_past_detection_window_fails_detection():
    junk = bytes(range(256)) * 300  # 76800 bytes
    got = _drive(dp.StreamDecoder(device="cpu"), junk, 4096)
    want = _drive(jax_dp.StreamDecoder(), junk, 4096)
    assert _summary(got) == _summary(want) == [("error", "FormatDetectionFailed")]
    assert isinstance(got[0], FormatDetectionFailed)


def test_input_buffer_full():
    handle = dp.DecodePipeline.spawn_with_buffers(2, 4, device="cpu")
    with pytest.raises(InputBufferFull):
        for _ in range(1000):
            handle.send(b"\x00" * 100)


def test_silent_consumption_is_no_audio_decoded():
    flac = (DATA / "flac" / "mono16.flac").read_bytes()
    header = flac[:42]  # "fLaC" and STREAMINFO: detected, nothing to decode
    got = _drive(dp.StreamDecoder(device="cpu"), header, 7)
    want = _drive(jax_dp.StreamDecoder(), header, 7)
    assert _summary(got) == _summary(want) == [("error", "NoAudioDecoded")]
    assert isinstance(got[0], NoAudioDecoded)
    assert dp.StreamDecoder(device="cpu").process(b"") == []


M4A = bytes(4) + b"ftypM4A " + bytes(20)


def test_unported_formats_raise_unsupported_format():
    """The formats the earlier slices refused decode now (the name is
    theirs): ``spawn_amr_nb`` and ``spawn_g729`` give the JAX package's
    events (its libavcodec decode; the port's owned decoders), and a
    detected M4A and WebM, and the LOAS/LATM and WebM spawns, decode since
    the containers were ported (``tests/test_torch_container_decode.py``):
    a bare M4A header now meets the MP4 walk's error, as in the JAX
    package, and detection and ``new_with_format`` build the M4A and WebM
    adapters."""
    got = _drive(dp.StreamDecoder(device="cpu"), M4A, 4096)
    want = _drive(jax_dp.StreamDecoder(), M4A, 4096)
    assert _summary(got) == _summary(want) == [("error", "DecodingFailed")]
    from soundkit_tpu_torch.tools import host_codec_fixtures as hcf

    for name, clip in [("spawn_amr_nb", "amrnb_edges"), ("spawn_g729", "g729_edges")]:
        data = hcf.clip_bytes(clip)
        h, jh = getattr(dp.DecodePipeline, name)(device="cpu"), getattr(jax_dp.DecodePipeline, name)()
        outs = []
        for handle, sink in ((h, outs), (jh, [])):
            for i in range(0, len(data), 313):
                handle.send_blocking(data[i:i + 313], sink)
            handle.send_blocking(b"", sink)
            sink.extend(handle.recv_all(timeout=60))
            if handle is jh:
                want = sink
        assert _summary(outs) == _summary(want) and _summary(outs)[0][:3] == ("audio", 8000, 1)
        assert b"".join(o.data for o in outs) == b"".join(o.data for o in want), name
    from soundkit_tpu_torch.codecs.aac import AacLatmAdapter
    from soundkit_tpu_torch.codecs.containers import M4aAdapter, WebmAdapter
    from soundkit_tpu_torch.demux.detect import AudioType

    assert not hasattr(dp, "_NOT_PORTED")
    for audio_type, cls in ((AudioType.M4A, M4aAdapter), (AudioType.WEBM, WebmAdapter)):
        assert isinstance(dp._init_decoder(audio_type, "cpu"), cls)
    for name, cls in (("spawn_aac_latm", AacLatmAdapter), ("spawn_webm", WebmAdapter)):
        h = getattr(dp.DecodePipeline, name)(device="cpu")
        assert isinstance(h._core._decoder, cls) and h._core.device.type == "cpu"
        h.send(b"")
        assert h.recv_all() == []
    for fmt, cls in (("m4a", M4aAdapter), ("webm", WebmAdapter)):
        dec = simple.MusicDecoder.new_with_format(fmt, device="cpu")
        assert isinstance(dec._core._decoder, cls)


@pytest.mark.parametrize("spawn,clip", [
    ("spawn_gsm", "gsm_standard"), ("spawn_ac3", "ac3_mono"), ("spawn_speex", "speex_nb"),
    ("spawn_alac", "alac_caf"), ("spawn_aiff", "aifc_alaw")])
def test_host_codec_spawns_decode(spawn, clip):
    """The spawns the earlier slices refused (GSM, AC-3, Speex, ALAC,
    AIFF) decode their clip as the JAX package's spawns do."""
    from soundkit_tpu_torch.tools import host_codec_fixtures as hcf

    data = hcf.clip_bytes(clip)
    outs = []
    for handle in (getattr(dp.DecodePipeline, spawn)(device="cpu"),
                   getattr(jax_dp.DecodePipeline, spawn)()):
        for i in range(0, len(data), 4096):
            handle.send_blocking(data[i:i + 4096])
        handle.send_blocking(b"")
        outs.append(handle.recv_all(timeout=60))
    got, want = outs
    assert _summary(got) == _summary(want) and got[0].channel_count >= 1
    assert _pcm(got).tobytes() == b"".join(o.data for o in want)


def _opus_raw(name: str) -> bytes:
    from soundkit_tpu_torch.tools import opus_fixtures

    return opus_fixtures.lane_raw(opus_fixtures.load_clips(names=(name,)), 1)[0]


# Ogg Opus (CELT, SILK, hybrid), raw Opus and Ogg Vorbis: CELT-only and
# Vorbis streams bit-exact, SILK and hybrid within 1 LSB (the port's
# resampler rounds its float64 sums where libswresample sums in float32)
OPUS_VORBIS = {
    "ogg_opus_celt": (lambda: (DATA / "opus" / "stereo96.opus").read_bytes(), 0),
    "ogg_opus_silk": (lambda: (DATA / "opus" / "silk_wb_stereo.opus").read_bytes(), 1),
    "ogg_opus_hybrid": (lambda: (DATA / "opus" / "hybrid_fb.opus").read_bytes(), 1),
    "opus_raw_celt": (lambda: _opus_raw("mono64"), 0),
    "opus_raw_silk": (lambda: _opus_raw("silk_nb"), 1),
    "vorbis": (lambda: (DATA / "vorbis" / "stereo44.ogg").read_bytes(), 0),
}


@pytest.mark.parametrize("fmt", list(OPUS_VORBIS))
@pytest.mark.parametrize("chunk", [313, 4096])
def test_opus_and_vorbis_autodetect_match_jax(fmt, chunk):
    make, lsb = OPUS_VORBIS[fmt]
    data = make()
    got = _drive(dp.StreamDecoder(device="cpu"), data, chunk)
    want = _drive(jax_dp.StreamDecoder(), data, chunk)
    _assert_same_outputs(got, want, lsb=lsb)
    assert not any(isinstance(o, DecodeError) for o in got)


@pytest.mark.parametrize("fmt,spawn", [("ogg_opus_hybrid", "spawn_ogg_opus"),
                                       ("opus_raw_celt", "spawn_opus"), ("vorbis", "spawn_vorbis")])
def test_opus_and_vorbis_spawns_match_jax(fmt, spawn):
    make, lsb = OPUS_VORBIS[fmt]
    data = make()[:60000]
    got = _recv_all(getattr(dp.DecodePipeline, spawn)(device="cpu"), data, 4096)
    want = _recv_all(getattr(jax_dp.DecodePipeline, spawn)(), data, 4096)
    _assert_same_outputs(got, want, lsb=lsb)
    for name in ("ogg-opus", "opus", "vorbis"):
        assert isinstance(simple.MusicDecoder.new_with_format(name, device="cpu"),
                          simple.MusicDecoder)


def _recv_all(handle, data: bytes, chunk: int):
    drained = []
    for i in range(0, len(data), chunk):
        handle.send_blocking(data[i:i + chunk], drained)
    handle.send_blocking(b"", drained)
    return drained + handle.recv_all()


THREADED = {
    "spawn_mp3": lambda: (dp.DecodePipeline.spawn_mp3(device="cpu"), _stream("mp3"),
                          dp.StreamDecoder(DecodeOptions(), Mp3Adapter("cpu"), "cpu")),
    "spawn": lambda: (dp.DecodePipeline.spawn(device="cpu"), _stream("aac"),
                      dp.StreamDecoder(device="cpu")),
    "spawn_raw_pcm": lambda: (
        dp.DecodePipeline.spawn_raw_pcm(RawPcmFormat.linear16(8000, 1), device="cpu"),
        _explicit("raw_pcm")[2],
        dp.StreamDecoder(DecodeOptions(), dp.RawPcmAdapter(RawPcmFormat.linear16(8000, 1)),
                         "cpu")),
    "spawn_g711": lambda: (
        dp.DecodePipeline.spawn_g711(G711Law.A_LAW, device="cpu"), _explicit("g711_alaw")[2],
        dp.StreamDecoder(DecodeOptions(), dp.G711Adapter(G711Law.A_LAW, 8000, 1, "cpu"), "cpu")),
    "spawn_g722": lambda: (dp.DecodePipeline.spawn_g722(device="cpu"), _explicit("g722")[2],
                           dp.StreamDecoder(DecodeOptions(), dp.G722Adapter("cpu"), "cpu")),
    "spawn_g726_with_rate": lambda: (
        dp.DecodePipeline.spawn_g726_with_rate(G726Rate.RATE_16000, G726Packing.RIGHT,
                                               device="cpu"),
        _explicit("g726_16")[2],
        dp.StreamDecoder(DecodeOptions(),
                         dp.G726Adapter(G726Rate.RATE_16000, G726Packing.RIGHT, "cpu"), "cpu")),
    "spawn_flac": lambda: (dp.DecodePipeline.spawn_flac(device="cpu"), _stream("flac"),
                           dp.StreamDecoder(DecodeOptions(), dp.FlacAdapter(), "cpu")),
    "spawn_aac_adts": lambda: (dp.DecodePipeline.spawn_aac_adts(device="cpu"), _stream("aac"),
                               dp.StreamDecoder(DecodeOptions(), AacAdtsAdapter(), "cpu")),
}


@pytest.mark.parametrize("name", list(THREADED))
def test_threaded_pipeline_equals_the_synchronous_core(name):
    handle, data, core = THREADED[name]()
    got = _recv_all(handle, data, 997)
    want = _drive(core, data, 997)
    assert handle.finished
    _assert_same_outputs(got, want)


def test_spawn_variants_with_buffers_and_options():
    data = _stream("wav")
    opts = DecodeOptions(16, 16000, 1)
    want = _drive(dp.StreamDecoder(opts, device="cpu"), data, 4096)
    for handle in (dp.DecodePipeline.spawn_with_options(opts, device="cpu"),
                   dp.DecodePipeline.spawn_with_buffers_and_options(3, 5, opts, device="cpu")):
        _assert_same_outputs(_recv_all(handle, data, 4096), want)
    plain = dp.DecodePipeline.spawn_with_buffers(3, 5, device="cpu")
    _assert_same_outputs(_recv_all(plain, data, 4096),
                         _drive(dp.StreamDecoder(device="cpu"), data, 4096))
    g726 = dp.DecodePipeline.spawn_g726(G726Packing.LEFT, device="cpu")
    wire = tfx.load_clips("g726_32")[0][:300]
    _assert_same_outputs(
        _recv_all(g726, wire, 64),
        _drive(jax_dp.StreamDecoder(JaxOptions(),
                                    jax_dp.G726Adapter(JaxRate.RATE_32000, JaxPacking.LEFT)),
               wire, 64))
    with pytest.raises(DecodeError):
        dp.DecodePipeline.spawn_g711(G711Law.MU_LAW, 0, 1, device="cpu")


def _raise_launch(*args, **kwargs):
    raise KernelLaunchError("g711_decode: CUDA launch failed with cudaError 98")


def test_a_failed_kernel_launch_reaches_the_caller(monkeypatch):
    from soundkit_tpu_torch.ops import companding

    monkeypatch.setattr(companding, "g711_decode", _raise_launch)
    data = _explicit("g711_mulaw")[2]
    core = dp.StreamDecoder(DecodeOptions(), dp.G711Adapter(G711Law.MU_LAW, 8000, 1, "cpu"),
                            "cpu")
    with pytest.raises(KernelLaunchError):
        core.process(data[:500])
    handle = dp.DecodePipeline.spawn_g711(G711Law.MU_LAW, device="cpu")
    handle.send(data[:500])
    handle.send(b"")
    with pytest.raises(KernelLaunchError):
        handle.recv_all(timeout=30)


def test_a_decoder_bug_is_still_error_as_data(monkeypatch):
    from soundkit_tpu_torch.ops import companding

    def boom(*args, **kwargs):
        raise IndexError("a decoder bug")

    monkeypatch.setattr(companding, "g711_decode", boom)
    core = dp.StreamDecoder(DecodeOptions(), dp.G711Adapter(G711Law.MU_LAW, 8000, 1, "cpu"),
                            "cpu")
    assert _summary(core.process(b"\x10" * 100)) == [("error", "DecodingFailed")]


def test_launch_check_and_device_faults():
    from soundkit_tpu_torch.utils.device import is_device_fault, launch_check

    launch_check("k", 0)
    with pytest.raises(KernelLaunchError, match="cudaError 700"):
        launch_check("k", 700)
    assert issubclass(KernelLaunchError, RuntimeError)
    assert is_device_fault(KernelLaunchError("x"))
    assert is_device_fault(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not is_device_fault(RuntimeError("bitstream overrun"))
    assert not is_device_fault(ValueError("CUDA error"))


def test_entry_points_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: dp.StreamDecoder(), lambda: dp.DecodePipeline.spawn(),
                 lambda: simple.MusicDecoder(),
                 lambda: dp.DecodePipeline.spawn_g722()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


@pytest.mark.parametrize("fmt", ["aac", "mp3"])
def test_music_decoder_matches_jax(fmt):
    data = _stream(fmt)[:20000]
    port = simple.MusicDecoder(device="cpu")
    ref = jax_simple.MusicDecoder()
    got, want = [], []
    for i in range(0, len(data), 2000):
        got += port.push(data[i:i + 2000])
        want += ref.push(data[i:i + 2000])
    got += port.flush()
    want += ref.flush()
    assert [(f.sample_rate, f.channels, f.bits, len(f.pcm)) for f in got] == \
        [(f.sample_rate, f.channels, f.bits, len(f.pcm)) for f in want]
    a = np.frombuffer(b"".join(f.pcm for f in got), "<i2").astype(np.int32)
    b = np.frombuffer(b"".join(f.pcm for f in want), "<i2")
    lsb = 1 if fmt == "mp3" else 0
    assert len(a) > 0 and np.abs(a - b).max() <= lsb
    named = simple.MusicDecoder.new_with_format(fmt, device="cpu")
    ref_named = jax_simple.MusicDecoder.new_with_format(fmt)
    a = np.frombuffer(b"".join(f.pcm for f in named.push(data)), "<i2").astype(np.int32)
    b = np.frombuffer(b"".join(f.pcm for f in ref_named.push(data)), "<i2")
    assert len(a) == len(b) > 0 and np.abs(a - b).max() <= lsb


def test_music_decoder_raises_errors():
    with pytest.raises(FormatDetectionFailed):
        dec = simple.MusicDecoder(device="cpu")
        dec.push(bytes(range(256)) * 300)
    with pytest.raises(ValueError, match="unknown format"):
        simple.MusicDecoder.new_with_format("xyz", device="cpu")


def test_aac_deboxer_and_lc_stream_decoder_match_jax():
    data = (DATA / "castanets.aac").read_bytes()[:25000]
    port, ref = simple.AacDeboxer(), jax_simple.AacDeboxer()
    aus, ref_aus = [], []
    for i in range(0, len(data), 777):
        aus += port.push(data[i:i + 777])
        ref_aus += ref.push(data[i:i + 777])
    assert aus == ref_aus and len(aus) > 10
    assert port.flush() == ref.flush() == []
    assert port.audio_specific_config == ref.audio_specific_config
    dec = simple.AacLcStreamDecoder(port.audio_specific_config)
    ref_dec = jax_simple.AacLcStreamDecoder(ref.audio_specific_config)
    assert (dec.sample_rate, dec.channels) == (ref_dec.sample_rate, ref_dec.channels)
    for au in aus:
        np.testing.assert_array_equal(dec.decode_planar(au), ref_dec.decode_planar(au))
    out = np.zeros(4096, np.float64)
    dec2 = simple.AacLcStreamDecoder(port.audio_specific_config)
    ref2 = jax_simple.AacLcStreamDecoder(ref.audio_specific_config)
    for au in aus[:3]:
        n = dec2.decode_interleaved_into(au, out)
        np.testing.assert_array_equal(out[:n], ref2.decode_interleaved(au))
    # the same AUs in an M4A: the port's walk (``demux/mp4.py``) gives them back with
    # the ASC, as the JAX package's does; an M4A with no moov raises in both
    from soundkit_tpu_torch.tools import host_codec_fixtures as hcf

    m4a = hcf.mux_mp4("aac", port.audio_specific_config, aus, dec.sample_rate, dec.channels, 1024)
    mp4, ref4 = simple.AacDeboxer(), jax_simple.AacDeboxer()
    assert mp4.push(m4a) == ref4.push(m4a) == []
    assert mp4.flush() == ref4.flush() == aus
    assert mp4.audio_specific_config == ref4.audio_specific_config == port.audio_specific_config
    from soundkit_tpu.demux.mp4 import Mp4Error as JaxMp4Error
    from soundkit_tpu_torch.demux.mp4 import Mp4Error

    for deboxer, error in ((simple.AacDeboxer(), Mp4Error), (jax_simple.AacDeboxer(), JaxMp4Error)):
        deboxer.push(b"\x00\x00\x00\x18ftypM4A " + bytes(20))
        with pytest.raises(error, match="no moov box"):
            deboxer.flush()
    with pytest.raises(ValueError, match="only AAC-LC"):
        simple.AacLcStreamDecoder(bytes([5 << 3, 0x10]))
