"""Port parity of the owned Opus encoders: the range encoder and the
Laplace coder (``codecs/opus_enc_rc.py``), the CELT encoder
(``codecs/opus_celt_enc.py``) on its native path (the port's build of
``native_src/src/celt_parse.cpp``, ``codecs/celt_native.NativeCeltEncoder``)
and its Python path (``native=False``), the SILK encoder
(``codecs/opus_silk_enc.py``, native ``codecs/silk_native.NativeSilkEncoder``
and Python), the hybrid encoder (``codecs/opus_hybrid_enc.py``, Python
SILK), ``codecs/encoders.OpusEncoder``'s routes and
``encode_to_soundkit_stream``, and ``demux/ogg.OggOpusWriter``: each
against the JAX package's on the same seeded numpy input, with equal
bytes. The JAX package's Python SILK path is its fallback: an
``OpusSilkEncoder`` whose ``_native`` is cleared after construction. The
port's packets decode through the port's owned decoder as the JAX
package's decoder decodes them: CELT bit for bit, SILK and hybrid at 90 dB
with equal lengths (the port's SILK resampler rounds its float64 sums
where libswresample sums in float32, ``tests/test_torch_opus_stream.py``).
Inputs are short: a few frames on the Python paths, 0.5 s on the native
ones."""
import numpy as np
import pytest

from soundkit_tpu.codecs import encoders as jax_encoders
from soundkit_tpu.codecs import opus as jax_opus
from soundkit_tpu.codecs import opus_celt_enc as jax_celt_enc
from soundkit_tpu.codecs import opus_core as jax_opus_core
from soundkit_tpu.codecs import opus_enc_rc as jax_rc
from soundkit_tpu.codecs import opus_hybrid_enc as jax_hybrid_enc
from soundkit_tpu.codecs import opus_silk_enc as jax_silk_enc
from soundkit_tpu.demux import ogg as jax_ogg
from soundkit_tpu_torch.codecs import encoders, opus, opus_celt_enc, opus_core, opus_enc_rc
from soundkit_tpu_torch.codecs import opus_hybrid_enc, opus_silk_enc
from soundkit_tpu_torch.demux import ogg

from torch_port_helpers import snr_db

RATE = 48000


def _music(n: int, channels: int, seed: int = 5, transient: bool = False) -> np.ndarray:
    """[n, channels] float PCM in [-1, 1]: two tones and noise, the
    right channel a scaled, shifted copy; ``transient`` adds decaying
    bursts every 6000 samples."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.4 * np.sin(0.03 * t) + 0.1 * np.sin(0.31 * t) + 0.02 * rng.standard_normal(n)
    if transient:
        x *= 0.05
        for p in range(1500, n - 2000, 6000):
            x[p:p + 2000] += 0.5 * np.sin(0.3 * np.arange(2000)) * np.exp(-np.arange(2000) / 300.0)
    return np.stack([x, 0.8 * np.roll(x, 7)], axis=1)[:, :channels]


def _voice(n: int, channels: int, seed: int = 3) -> np.ndarray:
    """[n, channels] voiced-speech-like PCM: harmonics of a gliding pitch
    under a syllable envelope, with breath noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    f0 = 140 + 30 * np.sin(2 * np.pi * 1.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / RATE
    x = sum(np.sin(k * phase) / k for k in range(1, 12))
    x = 0.25 * x * (0.55 + 0.45 * np.sin(2 * np.pi * 3.1 * t)) + 0.01 * rng.standard_normal(n)
    return np.stack([x, 0.6 * x + 0.01 * rng.standard_normal(n)], axis=1)[:, :channels]


def _packets(enc, pcm, slab: int = 0):
    """All packets of ``enc`` over ``pcm`` pushed whole (or in slabs of
    ``slab`` samples), then flushed."""
    out = []
    step = slab or len(pcm)
    for i in range(0, len(pcm), step):
        out += enc.push(pcm[i:i + step])
    return out + enc.flush()


# ---------------------------------------------------------------------------
# the range encoder
# ---------------------------------------------------------------------------

def _program(seed: int, size: int):
    rng = np.random.default_rng(seed)
    program, bits = [], 0.0
    while bits < size * 8 - 64:
        k = int(rng.integers(0, 7))
        if k == 0:
            program.append(("bit", int(rng.integers(0, 2)), int(rng.integers(1, 13))))
            bits += program[-1][2]
        elif k == 1:
            ft = int(rng.integers(2, 1 << 16))
            program.append(("uint", int(rng.integers(0, ft)), ft))
            bits += np.log2(ft) + 1
        elif k == 2:
            qn = 2 * int(rng.integers(1, 64))
            program.append(("tri", int(rng.integers(0, qn + 1)), qn))
            bits += np.log2(qn + 1) + 1
        elif k == 3:
            k0 = int(rng.integers(1, 32))
            program.append(("step", int(rng.integers(0, 2 * k0 + 1)), k0))
            bits += np.log2(2 * k0 + 1) + 1
        elif k == 4:
            nb = int(rng.integers(1, 17))
            program.append(("raw", int(rng.integers(0, 1 << nb)), nb))
            bits += nb
        elif k == 5:
            ft = int(rng.integers(4, 1 << 15))
            fl = int(rng.integers(0, ft - 1))
            program.append(("enc", fl, int(rng.integers(fl + 1, ft + 1)), ft))
            bits += 16
        else:
            # the CELT coarse-energy (fs, decay) range, saturating values included
            program.append(("laplace", int(rng.integers(-40, 41)), int(rng.integers(1, 200)) << 7,
                            int(rng.integers(1, 200)) << 6))
            bits += 16
    return program


def _encode_program(mod, program, size: int):
    enc = mod.RangeEncoder(size)
    coded, tells = [], []
    for op in program:
        if op[0] == "bit":
            enc.enc_bit_logp(op[1], op[2])
        elif op[0] == "uint":
            enc.enc_uint(op[1], op[2])
        elif op[0] == "tri":
            enc.enc_uint_tri(op[1], op[2])
        elif op[0] == "step":
            enc.enc_uint_step(op[1], op[2])
        elif op[0] == "raw":
            enc.rawbits(op[1], op[2])
        elif op[0] == "enc":
            enc.encode(op[1], op[2], op[3])
        else:
            coded.append(mod.laplace_encode(enc, op[1], op[2], op[3]))
        tells.append((enc.tell(), enc.tell_frac()))
    return enc.finalize(), coded, tells


@pytest.mark.parametrize("seed", range(8))
def test_range_encoder_writes_the_jax_packages_bytes(seed):
    size = int(np.random.default_rng(100 + seed).integers(8, 300))
    program = _program(seed, size)
    got = _encode_program(opus_enc_rc, program, size)
    assert got == _encode_program(jax_rc, program, size)
    assert len(got[0]) == size


@pytest.mark.parametrize("fs0,decay", [(10 << 7, 6 << 6), (72 << 7, 127 << 6), (1 << 7, 1 << 6)])
def test_laplace_interval_equals_the_jax_packages(fs0, decay):
    for val in range(-300, 301, 7):
        assert opus_enc_rc.laplace_interval(fs0, decay, val) == \
            jax_rc.laplace_interval(fs0, decay, val)


# ---------------------------------------------------------------------------
# CELT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("frame_size", [120, 240, 480, 960])
def test_celt_python_encoder_writes_the_jax_packages_packets(frame_size, channels):
    """The reference's definition of the encoder: a few frames each."""
    pcm = _music(6 * frame_size + 100, channels, seed=frame_size)
    port = opus_celt_enc.OpusCeltEncoder(channels, 64000, frame_size, native=False)
    ref = jax_celt_enc.OpusCeltEncoder(channels, 64000, frame_size, native=False)
    assert port._native is None and ref._native is None
    got = _packets(port, pcm, slab=frame_size + 37)
    assert got == _packets(ref, pcm, slab=frame_size + 37)
    assert len(got) == len(pcm) // frame_size and all(len(p) == port.bytes_per_frame + 1 for p in got)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("frame_size", [120, 240, 480, 960])
def test_celt_native_encoder_writes_the_jax_packages_packets(frame_size, channels):
    """The port's native build against the JAX package's native build
    over 0.5 s, and against both Python encoders on the first frames."""
    pcm = _music(RATE // 2, channels, seed=frame_size)
    port = opus_celt_enc.OpusCeltEncoder(channels, 64000, frame_size)
    ref = jax_celt_enc.OpusCeltEncoder(channels, 64000, frame_size)
    assert port._native is not None and ref._native is not None
    got = _packets(port, pcm)
    assert got == _packets(ref, pcm)
    head = pcm[:4 * frame_size + 200]
    py = _packets(opus_celt_enc.OpusCeltEncoder(channels, 64000, frame_size, native=False), head)
    assert got[:4] == py[:4]


@pytest.mark.parametrize("native", [True, False])
def test_celt_transient_frames_are_the_jax_packages(native):
    pcm = _music(RATE // 2 if native else 6 * 960, 2, seed=9, transient=True)
    pre = opus_celt_enc.OpusCeltEncoder(2, 96000)._preemph(pcm)
    hits = [opus_celt_enc.detect_transient(pre[:, f * 960: f * 960 + 1080], 960, 8)
            for f in range((pre.shape[1] - 120) // 960)]
    assert any(hits) and not all(hits)
    port = opus_celt_enc.OpusCeltEncoder(2, 96000, native=native)
    ref = jax_celt_enc.OpusCeltEncoder(2, 96000, native=native)
    assert _packets(port, pcm, slab=1234) == _packets(ref, pcm, slab=1234)


def test_celt_native_encoder_raises_where_the_jax_package_falls_back(monkeypatch):
    """A stated departure: a native library that fails to load raises;
    ``native=False`` is the explicit way to the Python encoder."""
    from soundkit_tpu_torch.codecs import celt_native

    def broken(channels):
        raise celt_native.CeltNativeError("library failed to load")

    monkeypatch.setattr(celt_native, "NativeCeltEncoder", broken)
    with pytest.raises(celt_native.CeltNativeError):
        opus_celt_enc.OpusCeltEncoder(2, 64000)
    assert opus_celt_enc.OpusCeltEncoder(2, 64000, native=False)._celt is not None


# ---------------------------------------------------------------------------
# SILK
# ---------------------------------------------------------------------------

def _jax_silk(bw: str, channels: int, native: bool):
    enc = jax_silk_enc.OpusSilkEncoder(bw, 24000, channels)
    assert enc._native is not None
    if not native:
        enc._native = None  # the JAX package's fallback: its Python encoder
    return enc


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bw", ["nb", "mb", "wb"])
def test_silk_native_encoder_writes_the_jax_packages_packets(bw, channels):
    pcm = _voice(RATE // 2, channels, seed=channels)
    port = opus_silk_enc.OpusSilkEncoder(bw, 24000, channels)
    assert port._native is not None
    got = _packets(port, pcm, slab=4000)
    assert got == _packets(_jax_silk(bw, channels, True), pcm, slab=4000)
    assert len(got) >= 25 and all(1 <= len(p) <= 1275 for p in got)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bw", ["nb", "mb", "wb"])
def test_silk_python_encoder_writes_the_jax_packages_packets(bw, channels):
    pcm = _voice(6 * 960, channels, seed=channels)
    port = opus_silk_enc.OpusSilkEncoder(bw, 24000, channels, native=False)
    assert port._native is None
    got = _packets(port, pcm)
    assert got == _packets(_jax_silk(bw, channels, False), pcm)
    native = _packets(opus_silk_enc.OpusSilkEncoder(bw, 24000, channels), pcm)
    assert got == native


def test_silk_native_encoder_raises_where_the_jax_package_falls_back(monkeypatch):
    from soundkit_tpu_torch.codecs import silk_native

    def broken(bandwidth, channels=1):
        raise silk_native.SilkNativeError("library failed to load")

    monkeypatch.setattr(silk_native, "NativeSilkEncoder", broken)
    with pytest.raises(silk_native.SilkNativeError):
        opus_silk_enc.OpusSilkEncoder("wb", 24000, 1)
    assert opus_silk_enc.OpusSilkEncoder("wb", 24000, 1, native=False)._native is None


# ---------------------------------------------------------------------------
# hybrid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bw", ["swb", "fb"])
def test_hybrid_encoder_writes_the_jax_packages_packets(bw, channels):
    pcm = _voice(10 * 960, channels, seed=7) + 0.3 * _music(10 * 960, channels, seed=7)
    port = opus_hybrid_enc.OpusHybridEncoder(bw, 32000, channels)
    ref = jax_hybrid_enc.OpusHybridEncoder(bw, 32000, channels)
    got = _packets(port, pcm, slab=2000)
    assert got == _packets(ref, pcm, slab=2000)
    assert len(got) == 10 and all(port.bytes_per_frame < len(p) <= 1276 for p in got)


# ---------------------------------------------------------------------------
# OpusEncoder, the soundkit framing and the Ogg writer
# ---------------------------------------------------------------------------

ROUTES = [  # (kwargs, backend, samples of 48 kHz i16 input a channel)
    (dict(channels=2, bit_rate=64000), "owned", RATE // 2),
    (dict(channels=1, bit_rate=32000), "owned", RATE // 2),
    (dict(channels=1, bit_rate=24000, mode="voice"), "owned-silk", RATE // 2),
    (dict(channels=2, bit_rate=32000, mode="voice", voice_bandwidth="nb"), "owned-silk", RATE // 2),
    (dict(channels=1, bit_rate=32000, mode="voice", voice_bandwidth="fb"), "owned-hybrid", 4 * 960),
]


def _i16(pcm: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(pcm * 32767), -32768, 32767).astype(np.int16).reshape(-1)


@pytest.mark.parametrize("kw,backend,n", ROUTES)
def test_opus_encoder_routes_and_soundkit_stream_equal_the_jax_packages(kw, backend, n):
    src = _voice(n, kw["channels"]) if kw.get("mode") == "voice" else _music(n, kw["channels"])
    samples = _i16(src)
    port, ref = encoders.OpusEncoder(**kw), jax_encoders.OpusEncoder(**kw)
    assert (port.backend, port.frame_size, port.pre_skip) == \
        (ref.backend, ref.frame_size, ref.pre_skip) == (backend, 960, 0)
    got = port.encode_i16_packets(samples[: len(samples) // 2]) + \
        port.encode_i16_packets(samples[len(samples) // 2:]) + port.flush_packets()
    want = ref.encode_i16_packets(samples[: len(samples) // 2]) + \
        ref.encode_i16_packets(samples[len(samples) // 2:]) + ref.flush_packets()
    assert got == want
    stream = encoders.OpusEncoder(**kw).encode_to_soundkit_stream(samples)
    assert stream == jax_encoders.OpusEncoder(**kw).encode_to_soundkit_stream(samples)
    assert stream[:8] == b"OpusHead"
    # the soundkit framing decodes through the port's stream decoder as the JAX package's
    got_pcm = opus.OpusStreamDecoder().decode_f32(stream)
    want_pcm = jax_opus.OpusStreamDecoder().decode_f32(stream)
    assert got_pcm.shape == want_pcm.shape and got_pcm.size > 0
    if backend == "owned":
        np.testing.assert_array_equal(got_pcm, want_pcm)
    else:
        assert snr_db(got_pcm, want_pcm) >= 90


@pytest.mark.parametrize("frame_size", [480, 960])
def test_ogg_opus_writer_writes_the_jax_packages_pages(frame_size):
    pcm = _music(RATE // 2, 2, seed=2)
    packets = _packets(opus_celt_enc.OpusCeltEncoder(2, 96000, frame_size), pcm)
    kw = dict(channels=2, pre_skip=312 if frame_size == 480 else 0, output_gain=-256)
    port, ref = ogg.OggOpusWriter(**kw), jax_ogg.OggOpusWriter(**kw)
    got, want = [], []
    for i, p in enumerate(packets):
        n = 960 if i == 3 else 0  # one granule step given by the caller
        port.write_packet(p, n)
        ref.write_packet(p, n)
        if i % 9 == 0:
            got.append(port.take())
            want.append(ref.take())
    got.append(port.close())
    want.append(ref.close())
    assert got == want
    assert port.close() == b""
    with pytest.raises(ValueError):
        port.write_packet(packets[0])
    wire = b"".join(got)
    # the port's Ogg Opus decoder reads the port's file as the JAX package's does
    a, b = opus.OggOpusDecoder().decode_f32(wire), jax_opus.OggOpusDecoder().decode_f32(wire)
    np.testing.assert_array_equal(a, b)
    assert a.size > 0


def test_ogg_opus_writer_empty_close_equals_the_jax_packages():
    assert ogg.OggOpusWriter(1).close() == jax_ogg.OggOpusWriter(1).close()
    w, r = ogg.OggOpusWriter(1, vendor=b"x", serial=7), jax_ogg.OggOpusWriter(1, vendor=b"x", serial=7)
    assert w.take() == r.take()
    assert w.close() == r.close()


# ---------------------------------------------------------------------------
# the port's packets through the port's decoder
# ---------------------------------------------------------------------------

DECODE_CASES = [("celt", 2), ("celt", 1), ("silk_wb", 1), ("silk_nb", 2), ("hybrid_fb", 2)]


def _encoder(mod_celt, mod_silk, mod_hybrid, kind: str, channels: int):
    if kind == "celt":
        return mod_celt.OpusCeltEncoder(channels, 64000)
    if kind.startswith("silk"):
        return mod_silk.OpusSilkEncoder(kind[5:], 24000, channels)
    return mod_hybrid.OpusHybridEncoder(kind[7:], 32000, channels)


@pytest.mark.parametrize("kind,channels", DECODE_CASES)
def test_port_packets_decode_through_the_port_as_through_the_jax_package(kind, channels):
    n = 8 * 960 if kind.startswith("hybrid") else RATE // 2
    pcm = _voice(n, channels) if kind != "celt" else _music(n, channels)
    packets = _packets(_encoder(opus_celt_enc, opus_silk_enc, opus_hybrid_enc, kind, channels), pcm)
    assert packets == _packets(_encoder(jax_celt_enc, jax_silk_enc, jax_hybrid_enc, kind,
                                        channels), pcm)
    port, ref = opus_core.OpusDecoder(channels), jax_opus_core.OpusDecoder(channels)
    got = np.concatenate([np.asarray(port.decode_packet(p), np.float32) for p in packets])
    want = np.concatenate([np.asarray(ref.decode_packet(p), np.float32) for p in packets])
    # (an NB stream starts 24 samples short: the SILK resampler's lead, in both packages)
    assert got.shape == want.shape and len(got) >= len(packets) * 960 - 24
    if kind == "celt":
        np.testing.assert_array_equal(got, want)
    else:
        assert snr_db(got, want) >= 90
    if kind == "celt":  # no codec delay: the decode lines up with the source
        assert snr_db(got[:n], pcm.astype(np.float32)) > 12
