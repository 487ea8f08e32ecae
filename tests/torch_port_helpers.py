"""Shared inputs for the port's parity tests (tests/test_torch_*.py),
and the generators of the committed fixtures.

Real v4 wires come from the committed 48 kHz fixtures
(tests/data/torch_port) through the port's standalone host parser.
The fixtures are made by the JAX package's encoders, so their
generators live here, on the test side; regenerate from the repository's root with

    PYTHONPATH=. python tests/torch_port_helpers.py aac
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py telephony
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py flac
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py mp3
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py opus
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py vorbis
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py host_codecs
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py containers
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py mpa
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py opus_ms
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py aac_mc
"""
from __future__ import annotations

import functools
import json
import struct
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

from soundkit_tpu_torch.codecs.telephony import AMR_MAGIC, amr_nb_frame_len
from soundkit_tpu_torch.models.telephony_batch import CODECS
from soundkit_tpu_torch.tools import (aac_fixtures, aac_mc_fixtures, celp_fixtures,
                                      container_fixtures, extract_celp_tables, flac_fixtures,
                                      host_codec_fixtures, mp3_fixtures, mpa_fixtures,
                                      opus_fixtures, opus_ms_fixtures, telephony_fixtures,
                                      vorbis_fixtures)

SR_INDEX_48K = 3
# AUs per clip that cover long, short (EIGHT_SHORT) and TNS frames
PICKS = (1, 9, 13, 22, 40, 94, 112)


@functools.lru_cache(maxsize=1)
def clip_aus() -> List[List[bytes]]:
    """Raw AUs (ADTS headers stripped) of every fixture clip."""
    return aac_fixtures.clip_aus(aac_fixtures.load_clips())


@functools.lru_cache(maxsize=1)
def host_parser():
    from soundkit_tpu_torch.native import AacHostParser

    return AacHostParser(SR_INDEX_48K)


def picked_aus() -> List[bytes]:
    """One AU per (clip, pick): 42 AUs of mixed content."""
    return [aus[i] for aus in clip_aus() for i in PICKS]


def v4_wire(aus: List[bytes]) -> np.ndarray:
    buf, overflow = host_parser().pack_v4(aus)
    assert not overflow
    return buf


def snr_db(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.sum((got - ref) ** 2)
    return float(10 * np.log10(np.sum(ref**2) / max(err, 1e-300)))


class OpusPacketEncoder:
    """``encode_i16`` of an audio packet (``core/audio_packet.py``,
    ``codecs/encoders.AudioEncoder``) over either package's ``encoders``
    module ``mod``: every packet of a fresh owned 48 kHz Opus encoder over
    the samples, flushed, joined."""

    def __init__(self, mod, channels: int = 2):
        self._mod, self._channels = mod, channels

    def encode_i16(self, samples):
        enc = self._mod.OpusEncoder(48000, self._channels, 64000)
        return b"".join(enc.encode_i16_packets(samples) + enc.flush_packets())


def lane_snrs(got, ref, lane_axis: int) -> np.ndarray:
    """SNR per lane; lanes whose reference is silent must match exactly
    and report +inf."""
    got = np.moveaxis(np.asarray(got, np.float64), lane_axis, 0)
    ref = np.moveaxis(np.asarray(ref, np.float64), lane_axis, 0)
    out = []
    for g, r in zip(got, ref):
        if not np.any(r):
            assert not np.any(g), "output on a silent lane"
            out.append(np.inf)
        else:
            out.append(snr_db(g, r))
    return np.array(out)


# ---------------------------------------------------------------------------
# AAC fixture synthesis (seeded numpy; stereo float in [-1, 1])
# ---------------------------------------------------------------------------

RATE = 48000
SECONDS = 4.0
BIT_RATE = 96000


def _env_bursts(n, onsets, decay_s, rng):
    env = np.zeros(n)
    t = np.arange(n) / RATE
    for o in onsets:
        m = t >= o
        env[m] += np.exp(-(t[m] - o) / decay_s) * rng.uniform(0.5, 1.0)
    return env


def _noise_pad(n, rng):
    t = np.arange(n) / RATE
    common = np.cumsum(rng.standard_normal(n)) * 0.002
    common -= np.convolve(common, np.ones(64) / 64, mode="same")
    l = rng.standard_normal(n) * 0.15 + common
    r = 0.6 * l + rng.standard_normal(n) * 0.1
    tone = 0.1 * np.sin(2 * np.pi * 330 * t)
    return np.stack([l + tone, r + tone])


def _castanets(n, rng):
    t = np.arange(n) / RATE
    onsets = np.cumsum(rng.uniform(0.09, 0.25, size=40))
    onsets = onsets[onsets < SECONDS - 0.05]
    env = _env_bursts(n, onsets, 0.004, rng)
    click = rng.standard_normal(n) * env * 0.8
    bed = 0.05 * np.sin(2 * np.pi * 220 * t)
    return np.stack([click + bed, 0.8 * click + bed])


def _chords(n, rng):
    t = np.arange(n) / RATE
    roots = (220.0, 174.6, 261.6, 196.0)
    x = np.zeros(n)
    seg = n // len(roots)
    for i, f0 in enumerate(roots):
        s = slice(i * seg, (i + 1) * seg if i < len(roots) - 1 else n)
        tt = t[s]
        vib = 1 + 0.003 * np.sin(2 * np.pi * 5 * tt)
        for ratio in (1.0, 1.26, 1.5, 2.0):
            for h in range(1, 6):
                x[s] += np.sin(2 * np.pi * f0 * ratio * h * vib * tt) * 0.05 / h
    return np.stack([x, 0.97 * x + rng.standard_normal(n) * 0.004])


def _speech_like(n, rng):
    t = np.arange(n) / RATE
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t)
    phase = np.cumsum(f0 / RATE)
    pulses = (np.diff(np.floor(phase), prepend=0) > 0).astype(float)
    x = np.zeros(n)
    for fc, bw in ((700, 90), (1200, 110), (2600, 160)):
        r = np.exp(-np.pi * bw / RATE)
        a1, a2 = -2 * r * np.cos(2 * np.pi * fc / RATE), r * r
        y = np.zeros(n)
        for i in range(2, n):
            y[i] = pulses[i] - a1 * y[i - 1] - a2 * y[i - 2]
        x += y
    syl = (np.sin(2 * np.pi * 3.1 * t) > -0.2).astype(float)
    syl = np.convolve(syl, np.ones(480) / 480, mode="same")
    x = x / np.max(np.abs(x)) * 0.7 * syl
    fric = rng.standard_normal(n) * 0.03 * (1 - syl)
    return np.stack([x + fric, x + fric])


def _drums(n, rng):
    t = np.arange(n) / RATE
    x = np.zeros(n)
    beat = 0.25
    for k in range(int(SECONDS / beat)):
        o = k * beat
        m = t >= o
        dt = t[m] - o
        if k % 2 == 0:
            x[m] += np.sin(2 * np.pi * (50 + 100 * np.exp(-dt * 30)) * dt) * np.exp(-dt * 12) * 0.6
        else:
            x[m] += rng.standard_normal(m.sum()) * np.exp(-dt * 25) * 0.4
        hh = t >= o + beat / 2
        dt2 = t[hh] - o - beat / 2
        x[hh] += np.diff(rng.standard_normal(hh.sum() + 1)) * np.exp(-dt2 * 80) * 0.15
    bass = 0.2 * np.sin(2 * np.pi * 55 * t)
    return np.stack([x + bass, 0.9 * x + bass])


def _sweep_pan(n, rng):
    t = np.arange(n) / RATE
    f = 50 * (16000 / 50) ** (t / SECONDS)
    s = np.sin(2 * np.pi * np.cumsum(f) / RATE) * 0.3
    pan = 0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * t)
    bursts = rng.standard_normal(n) * _env_bursts(n, np.arange(0.3, SECONDS, 0.7), 0.05, rng) * 0.3
    return np.stack([s * pan + bursts, s * (1 - pan) + 0.5 * bursts])


_SYNTH = {
    "noise_pad": _noise_pad,
    "castanets": _castanets,
    "chords": _chords,
    "speech_like": _speech_like,
    "drums": _drums,
    "sweep_pan": _sweep_pan,
}


def generate_aac_fixtures(directory: Path = aac_fixtures.FIXTURE_DIR) -> None:
    """Synthesize, encode with the JAX package's ``AacEncoder`` and
    write every clip of ``aac_fixtures.CLIPS`` (needs libavcodec)."""
    from soundkit_tpu.codecs.encoders import AacEncoder

    directory.mkdir(parents=True, exist_ok=True)
    n = int(RATE * SECONDS)
    for seed, name in enumerate(aac_fixtures.CLIPS):
        rng = np.random.default_rng(1000 + seed)
        x = _SYNTH[name](n, rng)
        x = x / max(np.max(np.abs(x)), 1e-9) * 0.85
        pcm = (x.T.reshape(-1) * 32767).astype(np.int16)
        enc = AacEncoder(RATE, 2, BIT_RATE)
        (directory / f"{name}.aac").write_bytes(enc.encode_i16(pcm) + enc.flush())


# ---------------------------------------------------------------------------
# telephony fixtures
# ---------------------------------------------------------------------------

def generate_telephony_fixtures(directory: Path = telephony_fixtures.FIXTURE_DIR) -> Dict[str, List[bytes]]:
    """Encode every clip of ``telephony_fixtures.pcm_clips`` for every
    codec with the JAX package's encoder and write the wire files;
    returns them by codec."""
    from soundkit_tpu.models.telephony_batch import BatchedTelephonyEncoder

    directory.mkdir(parents=True, exist_ok=True)
    out = {}
    for codec in CODECS:
        clips = telephony_fixtures.pcm_clips(telephony_fixtures.sample_rate(codec))
        enc = BatchedTelephonyEncoder(codec, len(clips), 2048)
        for i, pcm in enumerate(clips):
            enc.push(i, pcm)
        wires = [bytearray() for _ in clips]
        for _ in range(-(-len(clips[0]) // 2048)):
            for w, b in zip(wires, enc.encode_step()):
                w.extend(b)
        out[codec] = [bytes(w) for w in wires]
        for name, w in zip(telephony_fixtures.CLIPS, out[codec]):
            (directory / f"{name}.{codec}").write_bytes(w)
    return out


# ---------------------------------------------------------------------------
# FLAC fixtures
# ---------------------------------------------------------------------------

FLAC_WASTED_BITS = 2


def _flac_pcm(name: str, rng):
    """(rate, bits, samples [C, n] int64) of a FLAC fixture clip."""
    if name == "stereo16":  # correlated channels: mid/side frames, real LPC orders
        rate, bits, n = 44100, 16, 2 * 44100
        t = np.arange(n) / rate
        l = np.sin(2 * np.pi * 440 * t) * 0.6 + 0.2 * np.sin(2 * np.pi * 1870 * t) \
            + rng.standard_normal(n) * 0.004
        r = 0.9 * l + rng.standard_normal(n) * 0.002
        # second half: a sum and a difference of two sources, which mid/side codes best
        # (a smooth one and a noisy one)
        a = np.sin(2 * np.pi * 330 * t) * 0.5 + rng.standard_normal(n) * 0.0003
        b = np.sin(2 * np.pi * 1210 * t) * 0.1 + rng.standard_normal(n) * 0.008
        half = t >= 1.0
        l[half], r[half] = (a + b)[half], (a - b)[half]
        x = (np.stack([l, r]) * 20000).clip(-32768, 32767)
    elif name == "stereo24":  # past the 16-bit range
        rate, bits, n = 48000, 24, 48000
        t = np.arange(n)
        x = np.stack([6_000_000 * np.sin(0.003 * t) + rng.integers(-999, 999, n),
                      4_000_000 * np.sin(0.004 * t + 1)])
    elif name == "mono16":
        rate, bits, n = 16000, 16, 2 * 16000
        t = np.arange(n) / rate
        x = (8000 * np.sin(2 * np.pi * (200 + 300 * t) * t) + rng.standard_normal(n) * 60)[None]
    elif name == "const_wasted":  # left constant per frame, right with wasted bits
        rate, bits, n = 44100, 16, 44100
        t = np.arange(n) / rate
        left = np.repeat(rng.integers(-3000, 3000, -(-n // flac_fixtures.BLOCK_SIZE)),
                         flac_fixtures.BLOCK_SIZE)[:n]
        right = (9000 * np.sin(2 * np.pi * 330 * t) + rng.standard_normal(n) * 40).astype(np.int64)
        x = np.stack([left, right >> FLAC_WASTED_BITS << FLAC_WASTED_BITS])
    else:
        raise ValueError(name)
    return rate, bits, x.astype(np.int64)


def _wasted_frame_encoder(rate: int, bits: int, wasted: int):
    """A stereo ``FlacFrameEncoder`` that codes channels independently
    and declares ``wasted`` wasted bits on the right one (whose samples
    must be multiples of ``1 << wasted``); the JAX package's encoder
    never emits wasted bits on its own."""
    from soundkit_tpu.codecs import flac_encode as fe

    class WastedFrameEncoder(fe.FlacFrameEncoder):
        def encode_frame(self, samples):
            x = np.asarray(samples, np.int64)
            n = x.shape[1]
            assert not (x[1] & ((1 << wasted) - 1)).any()
            w = fe.BitWriter()
            # frame header (CRC-8 included) from the package's writer
            for b in self.write_frame_py(n, 1, [])[:-2]:
                w.write(b, 8)
            fe._write_subframe(w, fe._plan_subframe(x[0], self.bits, self.profile), n)
            sub = fe.BitWriter()
            fe._write_subframe(sub, fe._plan_subframe(x[1] >> wasted, self.bits - wasted,
                                                      self.profile), n)
            sub_bits = np.concatenate(sub._chunks)
            w.write_bits_array(sub_bits[:7])  # pad bit and subframe type
            w.write(1, 1)                     # wasted-bits flag
            w.write(1, wasted)                # unary: wasted - 1 zeros, then a one
            w.write_bits_array(sub_bits[8:])
            w.align()
            body = w.bytes()
            return body + fe._crc16(body).to_bytes(2, "big")

    return WastedFrameEncoder(rate, 2, bits)


def generate_flac_fixtures(directory: Path = flac_fixtures.FIXTURE_DIR) -> None:
    """Synthesize and encode every clip of ``flac_fixtures.CLIPS`` with
    the JAX package's ``FlacStreamEncoder`` and write the streams and
    their frame index."""
    from soundkit_tpu.codecs.flac_encode import FlacStreamEncoder

    directory.mkdir(parents=True, exist_ok=True)
    index = {}
    for seed, name in enumerate(flac_fixtures.CLIPS):
        rate, bits, x = _flac_pcm(name, np.random.default_rng(3000 + seed))
        enc = FlacStreamEncoder(rate, x.shape[0], bits, block_size=flac_fixtures.BLOCK_SIZE)
        if name == "const_wasted":
            enc._enc = _wasted_frame_encoder(rate, bits, FLAC_WASTED_BITS)
        enc.add(x)
        stream = enc.finish()
        frames = [len(f) for f in enc._frames]
        blocks = [flac_fixtures.BLOCK_SIZE] * (x.shape[1] // flac_fixtures.BLOCK_SIZE)
        if x.shape[1] % flac_fixtures.BLOCK_SIZE:
            blocks.append(max(x.shape[1] % flac_fixtures.BLOCK_SIZE, 16))
        index[name] = dict(rate=rate, channels=int(x.shape[0]), bits=bits,
                           header=len(stream) - sum(frames), frames=frames, blocks=blocks)
        (directory / f"{name}.flac").write_bytes(stream)
    (directory / "index.json").write_text(json.dumps(index, indent=1) + "\n")


def flac_clip_pcm(name: str) -> np.ndarray:
    """The samples [C, n] that ``generate_flac_fixtures`` encoded for ``name``."""
    return _flac_pcm(name, np.random.default_rng(3000 + flac_fixtures.CLIPS.index(name)))[2]


# ---------------------------------------------------------------------------
# MP3 fixtures
# ---------------------------------------------------------------------------

# clip: (rate, channels, bit rate, seconds)
MP3_CLIPS = {
    "stereo44": (44100, 2, 128000, 3.0),
    "stereo48": (48000, 2, 128000, 2.0),
    "lsf22": (22050, 2, 64000, 2.0),
    "mono16": (16000, 1, 32000, 2.0),
    "mono8": (8000, 1, 16000, 2.0),
}


def mp3_clip_pcm(name: str) -> np.ndarray:
    """The interleaved int16 samples ``generate_mp3_fixtures`` encodes
    for ``name``: a tone with vibrato under noise, clicks and noise
    bursts (block switching); for ``stereo44`` a correlated first half
    (M/S frames) and two independent channels after it."""
    rate, ch, _, seconds = MP3_CLIPS[name]
    rng = np.random.default_rng(4000 + mp3_fixtures.CLIPS.index(name))
    n = int(rate * seconds)
    t = np.arange(n) / rate
    tone = 0.3 * np.sin(2 * np.pi * (330 + 4 * np.sin(2 * np.pi * 5 * t)) * t)
    onsets = np.cumsum(rng.uniform(0.15, 0.4, size=int(seconds * 8)))
    env = np.zeros(n)
    for o in onsets[onsets < seconds - 0.05]:
        m = t >= o
        env[m] += np.exp(-(t[m] - o) / 0.006)
    x = tone + rng.standard_normal(n) * (0.02 + 0.7 * env)
    if ch == 1:
        pcm = x[:, None]
    else:
        pcm = np.stack([x, 0.85 * x + rng.standard_normal(n) * 0.01], axis=1)
        if name == "stereo44":
            half = t >= seconds / 2
            pcm[half, 1] = 0.4 * np.sin(2 * np.pi * 1230 * t[half]) + rng.standard_normal(
                int(half.sum())) * 0.05
    return (np.clip(pcm, -1, 1) * 26000).astype(np.int16).reshape(-1)


def generate_mp3_fixtures(directory: Path = mp3_fixtures.FIXTURE_DIR) -> None:
    """Encode every clip of ``mp3_fixtures.CLIPS`` with the JAX package's
    ``Mp3Encoder`` (libmp3lame) and write the streams and their frame
    index (frame lengths from the headers)."""
    from soundkit_tpu.codecs.encoders import Mp3Encoder
    from soundkit_tpu.codecs.mp3_native import parse_header

    directory.mkdir(parents=True, exist_ok=True)
    index = {}
    for name in mp3_fixtures.CLIPS:
        rate, ch, bit_rate, _ = MP3_CLIPS[name]
        enc = Mp3Encoder(rate, ch, bit_rate)
        data = enc.encode_i16(mp3_clip_pcm(name)) + enc.flush()
        frames, granules, pos = [], [], 0
        while pos < len(data):
            hdr = parse_header(data, pos)
            frames.append(hdr.frame_size)
            granules.append(1 if hdr.lsf else 2)
            pos += hdr.frame_size
        assert pos == len(data), name
        index[name] = dict(rate=rate, channels=ch, bit_rate=bit_rate, frames=frames,
                           granules=granules)
        (directory / f"{name}.mp3").write_bytes(data)
    (directory / "index.json").write_text(json.dumps(index, indent=1) + "\n")


# ---------------------------------------------------------------------------
# Ogg Opus (CELT) fixtures
# ---------------------------------------------------------------------------

# clip: (channels, bit rate, encoder backend, seconds, OpusHead output gain in Q7.8 dB)
OPUS_CLIPS = {
    "stereo96": (2, 96000, "libopus", 2.5, 0),
    "mono64": (1, 64000, "libopus", 2.5, 0),
    "owned": (2, 96000, "owned", 2.0, 0),
    "gain": (2, 64000, "libopus", 2.0, -1200),
}


def opus_clip_pcm(name: str) -> np.ndarray:
    """The interleaved int16 samples ``generate_opus_fixtures`` encodes
    for ``name`` at 48 kHz: a pitched tone (eleven harmonics of 196 Hz
    with vibrato; libopus turns its comb postfilter on for it) under
    noise, with decaying noise attacks (transient frames); the second
    channel a scaled copy with a 523 Hz tone."""
    ch, _, _, seconds, _ = OPUS_CLIPS[name]
    rng = np.random.default_rng(5000 + opus_fixtures.CLIPS.index(name))
    n = int(48000 * seconds)
    t = np.arange(n) / 48000
    f0 = 196 * (1 + 0.01 * np.sin(2 * np.pi * 4 * t))
    phase = 2 * np.pi * np.cumsum(f0) / 48000
    x = sum(np.sin(h * phase) / h for h in range(1, 12)) * 0.25
    onsets = np.cumsum(rng.uniform(0.2, 0.5, int(seconds * 5)))
    env = np.zeros(n)
    for o in onsets[onsets < seconds - 0.05]:
        m = t >= o
        env[m] += np.exp(-(t[m] - o) / 0.01)
    x = x + rng.standard_normal(n) * (0.01 + 0.6 * env)
    pcm = x[:, None] if ch == 1 else np.stack([x, 0.8 * x + 0.05 * np.sin(2 * np.pi * 523 * t)], 1)
    return (np.clip(pcm, -1, 1) * 26000).astype(np.int16).reshape(-1)


def generate_celt_fixtures(directory: Path) -> dict:
    """Encode every clip of ``opus_fixtures.CLIPS`` with the JAX
    package's ``OpusEncoder`` (libopus, or the owned CELT encoder), mux
    it with its ``OggOpusWriter`` (one packet a page) and write the
    streams and their index (header bytes, packet lengths, pre-skip and
    output gain; returned, not written). Every packet must be a
    single-frame 20 ms CELT packet; each libopus clip must carry
    comb-postfilter frames and transient frames (checked with the JAX
    package's CELT parse), and the owned encoder's clip none of the
    first."""
    from soundkit_tpu.codecs.celt_native import NativeCeltParser
    from soundkit_tpu.codecs.encoders import OpusEncoder
    from soundkit_tpu.codecs.opus_core import TOC_ATTRS
    from soundkit_tpu.codecs.opus_tables import tables
    from soundkit_tpu.demux.ogg import OggOpusWriter

    band_end = tables()["celt_band_end"].astype(int)
    index = {}
    for name in opus_fixtures.CLIPS:
        ch, bit_rate, backend, _, gain = OPUS_CLIPS[name]
        enc = OpusEncoder(48000, ch, bit_rate, backend=backend)
        packets = enc.encode_i16_packets(opus_clip_pcm(name)) + enc.flush_packets()
        parser, postfilter, transient = NativeCeltParser(ch), 0, 0
        for pkt in packets:
            mode, dur, stereo, bw, code = TOC_ATTRS[pkt[0]]
            assert (mode, dur, code, stereo) == ("celt", 20, 0, ch == 2), (name, TOC_ATTRS[pkt[0]])
            _, comb, short = parser.parse(pkt[1:], band_end[bw], ch)
            postfilter += bool(np.any(comb[2:8]) or np.any(comb[10:16]))
            transient += short
        if backend == "libopus":
            assert postfilter >= len(packets) // 2 and transient >= 4, (name, postfilter, transient)
        else:
            assert postfilter == 0 and transient >= 1, (name, postfilter, transient)
        writer = OggOpusWriter(ch, pre_skip=enc.pre_skip, output_gain=gain)
        header = writer.take()
        for pkt in packets:
            writer.write_packet(pkt)
        stream = header + writer.close()  # the last packet's page carries EOS
        index[name] = dict(channels=ch, bit_rate=bit_rate, encoder=backend,
                           pre_skip=enc.pre_skip, output_gain=gain, header=len(header),
                           packets=[len(p) for p in packets], postfilter_frames=postfilter,
                           transient_frames=int(transient))
        (directory / f"{name}.opus").write_bytes(stream)
    return index


# voice clip: (channels, bit rate, libopus max bandwidth, forced mode, OpusHead gain, mode, TOC
# bandwidth); libopus's VoIP application, its voice signal type
VOICE_CLIPS = {
    "silk_nb": (1, 12000, 1101, 1000, 0, "silk", 0),
    "silk_mb": (1, 16000, 1102, 1000, -600, "silk", 1),
    "silk_wb": (1, 20000, 1103, 1000, 0, "silk", 2),
    "silk_wb_stereo": (2, 24000, 1103, 1000, 0, "silk", 2),
    "hybrid_swb": (1, 24000, 1104, 1001, 0, "hybrid", 3),
    "hybrid_fb": (2, 32000, 1105, 1001, 0, "hybrid", 4),
}
VOICE_SECONDS = 3.0


def voice_clip_pcm(name: str) -> np.ndarray:
    """float32 [n, channels] at 48 kHz of voice clip ``name``: a harmonic
    source gliding around 140 Hz under moving resonances, in bursts with
    pauses of noise between them, and a 9 kHz component (the hybrid
    clips' CELT band); the stereo clip is L = R for its first third (so
    that SILK codes mid-only frames), then a delayed, scaled copy."""
    ch = VOICE_CLIPS[name][0]
    rng = np.random.default_rng(6000 + opus_fixtures.VOICE_CLIPS.index(name))
    n = int(48000 * VOICE_SECONDS)
    t = np.arange(n) / 48000
    f0 = 140 * (1 + 0.15 * np.sin(2 * np.pi * 0.7 * t))
    ph = 2 * np.pi * np.cumsum(f0) / 48000
    x = sum(np.sin(h * ph) / h ** 0.7 * (1 + 0.8 * np.sin(2 * np.pi * (500 + 300 * h) * t / 2000))
            for h in range(1, 25)) * 0.08
    env = (np.sin(2 * np.pi * 2.2 * t) > -0.3).astype(float)
    x = x * env + 0.02 * rng.standard_normal(n) * (1 - env) + 0.05 * np.sin(2 * np.pi * 9000 * t) * env
    if ch == 1:
        return x[:, None].astype(np.float32)
    pcm = np.stack([x, x], 1)
    pcm[n // 3:, 1] = np.roll(x, 9)[n // 3:] * 0.7 + 0.01 * rng.standard_normal(n - n // 3)
    return pcm.astype(np.float32)


@functools.lru_cache(maxsize=None)
def libopus():
    """The system's libopus (``libopus.so.0``) with the prototypes of its
    single-stream and multistream encoders and decoders, or None where it
    is absent (the card's machine has none). The encoders make fixtures;
    the decoders are the oracle of the multistream decode and of the SILK
    core at its internal rate."""
    import ctypes

    try:
        op = ctypes.CDLL("libopus.so.0")
    except OSError:
        return None
    P, I, V, F, B = (ctypes.POINTER, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
                     ctypes.c_char_p)
    for name, res, args in (
            ("opus_encoder_create", V, [I, I, I, P(I)]),
            ("opus_encoder_destroy", None, [V]),
            ("opus_encode_float", I, [V, P(F), I, B, I]),
            ("opus_decoder_create", V, [I, I, P(I)]),
            ("opus_decoder_destroy", None, [V]),
            ("opus_decode_float", I, [V, B, I, P(F), I, I]),
            ("opus_multistream_surround_encoder_create", V, [I, I, I, P(I), P(I), B, I, P(I)]),
            ("opus_multistream_encoder_create", V, [I, I, I, I, B, I, P(I)]),
            ("opus_multistream_encoder_destroy", None, [V]),
            ("opus_multistream_encode_float", I, [V, P(F), I, B, I]),
            ("opus_multistream_decoder_create", V, [I, I, I, I, B, P(I)]),
            ("opus_multistream_decoder_destroy", None, [V]),
            ("opus_multistream_decode_float", I, [V, B, I, P(F), I, I])):
        fn = getattr(op, name)
        fn.restype = res
        fn.argtypes = args
    # the ctls are variadic: their arguments are given typed at each call
    op.opus_encoder_ctl.restype = I
    op.opus_multistream_encoder_ctl.restype = I
    return op


def libopus_voice_packets(pcm: np.ndarray, bit_rate: int, max_bandwidth: int, mode: int,
                          toggle_channels: bool = False):
    """(packets, lookahead) of ``pcm`` float32 [n, channels] at 48 kHz by
    the system's libopus (:func:`libopus`) in its VoIP application: voice signal, ``bit_rate``,
    ``max_bandwidth`` (OPUS_BANDWIDTH_*) as the maximum and the set
    bandwidth, and ``mode`` forced (1000 SILK, 1001 hybrid, 1002 CELT; a
    list gives a packet's mode by its index). ``toggle_channels`` forces
    mono coding every other half second."""
    import ctypes

    op = libopus()
    ch = pcm.shape[1]
    err = ctypes.c_int(0)
    enc = ctypes.c_void_p(op.opus_encoder_create(48000, ch, 2048, ctypes.byref(err)))
    assert err.value == 0 and enc.value
    modes = mode if isinstance(mode, list) else None

    def ctl(req, v):
        assert op.opus_encoder_ctl(enc, ctypes.c_int(req), ctypes.c_int(v)) == 0, (req, v)

    try:
        for req, v in ((4024, 3001), (4002, bit_rate), (4004, max_bandwidth), (4008, max_bandwidth)):
            ctl(req, v)
        lookahead = ctypes.c_int(0)
        assert op.opus_encoder_ctl(enc, ctypes.c_int(4027), ctypes.byref(lookahead)) == 0
        packets = []
        for k, i in enumerate(range(0, len(pcm) - 960 + 1, 960)):
            ctl(11002, modes[k] if modes else mode)
            if toggle_channels:
                ctl(4022, 1 if (k // 25) % 2 else -1000)
            buf = ctypes.create_string_buffer(4000)
            r = op.opus_encode_float(enc, np.ascontiguousarray(pcm[i: i + 960]).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), 960, buf, 4000)
            assert r > 0, r
            packets.append(buf.raw[:r])
    finally:
        op.opus_encoder_destroy(enc)
    return packets, lookahead.value


def generate_opus_fixtures(directory: Path = opus_fixtures.FIXTURE_DIR) -> None:
    """The CELT clips (:func:`generate_celt_fixtures`) and the voice clips
    (:func:`generate_voice_fixtures`), and their index."""
    directory.mkdir(parents=True, exist_ok=True)
    index = generate_celt_fixtures(directory)
    index.update(generate_voice_fixtures(directory))
    (directory / "index.json").write_text(json.dumps(index, indent=1) + "\n")


def generate_voice_fixtures(directory: Path) -> dict:
    """Encode every voice clip of ``opus_fixtures.VOICE_CLIPS`` with
    libopus (:func:`libopus_voice_packets`), mux it with the JAX package's
    ``OggOpusWriter`` (one packet a page) and write the streams; return
    their index entries. Every packet must be a single-frame 20 ms packet
    of the clip's mode and bandwidth (by its TOC); the SILK stereo clip
    must code mono and stereo packets and mid-only frames (by the JAX
    package's SILK parse)."""
    from soundkit_tpu.codecs.opus_core import TOC_ATTRS
    from soundkit_tpu.codecs.silk_native import NativeSilkBatch
    from soundkit_tpu.demux.ogg import OggOpusWriter

    index = {}
    for name in opus_fixtures.VOICE_CLIPS:
        ch, bit_rate, max_bw, force, gain, mode, bw = VOICE_CLIPS[name]
        packets, lookahead = libopus_voice_packets(voice_clip_pcm(name), bit_rate, max_bw, force,
                                                   toggle_channels=name == "silk_wb_stereo")
        stereo = 0
        for pkt in packets:
            m, dur, st, b, code = TOC_ATTRS[pkt[0]]
            assert (m, dur, code, b) == (mode, 20, 0, bw), (name, TOC_ATTRS[pkt[0]])
            stereo += st
        midonly = 0
        if mode == "silk" and ch == 2:
            parser = NativeSilkBatch(1, 2)
            for pkt in packets:
                coded = 2 if TOC_ATTRS[pkt[0]][2] else 1
                p = parser.parse_many([pkt[1:]], [bw], [coded], [20], [1])
                assert p["n"][0] > 0, name
                midonly += int(p["flags"][0, 3])
            assert 0 < stereo < len(packets) and midonly > 0, (name, stereo, midonly)
        else:
            assert stereo == (len(packets) if ch == 2 else 0), (name, stereo)
        writer = OggOpusWriter(ch, pre_skip=lookahead, output_gain=gain)
        header = writer.take()
        for pkt in packets:
            writer.write_packet(pkt)
        stream = header + writer.close()
        index[name] = dict(channels=ch, bit_rate=bit_rate, encoder="libopus", mode=mode,
                           bandwidth=bw, pre_skip=lookahead, output_gain=gain, header=len(header),
                           packets=[len(p) for p in packets], stereo_frames=stereo,
                           midonly_frames=midonly)
        (directory / f"{name}.opus").write_bytes(stream)
    return index


def ogg_opus(head: bytes, packets) -> bytes:
    """An Ogg Opus stream of ``head`` (an OpusHead), an OpusTags page and
    one page a packet, by the JAX package's page writer."""
    from soundkit_tpu.demux.ogg import build_ogg_page

    tags = b"OpusTags" + struct.pack("<I", 2) + b"sk" + struct.pack("<I", 0)
    pages = [build_ogg_page([head], 7, 0, 0, header_type=2), build_ogg_page([tags], 7, 1, 0)]
    for i, p in enumerate(packets):
        pages.append(build_ogg_page([p], 7, 2 + i, 960 * (i + 1)))
    return b"".join(pages)


def hybrid_redundancy_packets(n: int):
    """``n`` single-frame 20 ms hybrid FB packets by libopus whose first
    carries CELT-to-hybrid transition redundancy: the encoder runs four
    CELT frames first, which are dropped, as a receiver joining the
    stream at the switch sees it."""
    pcm = voice_clip_pcm("hybrid_fb")[: 960 * (n + 4)]
    packets, _ = libopus_voice_packets(pcm, 32000, 1105, [1002] * 4 + [1001] * n)
    return packets[4:]


REROUTE_CASES = ("silk_bandwidth_switch", "ten_ms_celt", "code3_multiframe", "mapping_family_1",
                 "three_channels", "mode_switch", "hybrid_redundancy_start")


def opus_reroute_case(clips, case: str):
    """(OpusHead, packets, the refusal's message) of an Ogg Opus lane that
    the JAX package's group reroutes to its host decoder: a SILK NB lane
    that switches to WB, a 10 ms CELT packet, a code-3 packet of two
    frames, an OpusHead of mapping family 1 without its channel mapping
    table or of three channels in family 0 (neither package opens them),
    a switch from CELT to SILK in mid-stream, and a hybrid stream that
    starts on a transition-redundancy packet (its lane is frozen by the
    decode, and refused at its next push)."""
    clip = clips[0]
    celt = clip.packets[:6]
    head2 = clip.head
    ten_ms = bytes([(30 << 3) | (celt[2][0] & 7)]) + celt[2][1:]  # CELT FB 10 ms
    frame = celt[3][1:]
    multi = bytes([celt[3][0] | 3, 2]) + frame + frame  # code 3, two CBR frames
    family1 = head2[:18] + b"\x01"
    three = head2[:9] + b"\x03" + head2[10:]
    voice = {c.name: c for c in opus_fixtures.load_clips(names=opus_fixtures.VOICE_CLIPS)}
    nb, wb = voice["silk_nb"].packets, voice["silk_wb"].packets
    return {
        "silk_bandwidth_switch": (head2, nb[:4] + wb[4:6], "silk bandwidth switch"),
        "ten_ms_celt": (head2, celt[:2] + [ten_ms], "non-20ms/multiframe"),
        "code3_multiframe": (head2, celt[:3] + [multi], "non-20ms/multiframe"),
        "mapping_family_1": (family1, celt, "unsupported OpusHead"),
        "three_channels": (three, celt, "unsupported OpusHead"),
        "mode_switch": (head2, celt[:4] + nb[:1], "mid-stream mode switch"),
        "hybrid_redundancy_start": (head2, hybrid_redundancy_packets(4),
                                    "hybrid transition redundancy"),
    }[case]


# ---------------------------------------------------------------------------
# the SILK resampler's probed taps
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Ogg Vorbis fixtures
# ---------------------------------------------------------------------------

# libvorbis clip: (rate, channels, seconds)
VORBIS_CLIPS = {"stereo44": (44100, 2, 3.0), "stereo44b": (44100, 2, 2.5), "mono22": (22050, 1, 2.0)}
VORBIS_PAGE_BODY = 4096  # a page is closed before a packet would pass this many body bytes
VORBIS_FLOOR0_PACKETS = 24


def vorbis_clip_pcm(name: str) -> np.ndarray:
    """The float32 samples [n, C] ``generate_vorbis_fixtures`` encodes for
    ``name``: a tone with vibrato, clicks (40-sample bursts: libvorbis
    codes them in short blocks) and decaying noise bursts; in stereo the
    second channel uncorrelated noise under its own tone."""
    rate, ch, seconds = VORBIS_CLIPS[name]
    rng = np.random.default_rng(7000 + list(VORBIS_CLIPS).index(name))
    n = int(rate * seconds)
    t = np.arange(n) / rate
    f0 = {"stereo44": 330.0, "stereo44b": 523.0, "mono22": 220.0}[name]
    x = 0.25 * np.sin(2 * np.pi * np.cumsum(f0 * (1 + 0.005 * np.sin(2 * np.pi * 5 * t))) / rate)
    for o in rng.uniform(0.05, seconds - 0.05, int(6 * seconds)):
        i = int(o * rate)
        x[i: i + 40] += rng.uniform(-0.9, 0.9, len(x[i: i + 40]))
    env = np.zeros(n)
    for o in rng.uniform(0, seconds, int(2 * seconds)):
        m = t >= o
        env[m] += np.exp(-(t[m] - o) / 0.05)
    x = x + rng.standard_normal(n) * (0.01 + 0.3 * env)
    if ch == 1:
        return np.clip(x, -1, 1)[:, None].astype(np.float32)
    y = 0.15 * rng.standard_normal(n) * (0.3 + env) + 0.1 * np.sin(2 * np.pi * 2 * f0 * t)
    return np.clip(np.stack([x, y], 1), -1, 1).astype(np.float32)


def _vorbis_ogg(headers: List[bytes], packets: List[bytes], sizes: List[int], serial: int):
    """(header bytes, audio pages) of an Ogg Vorbis stream by the JAX
    package's page writer: the identification header alone on the first
    page, the comment and setup headers on the second, then whole audio
    packets a page, a page closed before a packet would pass
    VORBIS_PAGE_BODY body bytes or 255 lacing values. ``sizes`` are the
    packets' block sizes; a page's granule counts the samples its packets
    finish (the first packet none, then ``prev/4 + n/4`` each)."""
    from soundkit_tpu.demux.ogg import build_ogg_page

    header = build_ogg_page([headers[0]], serial, 0, 0, header_type=2) + \
        build_ogg_page(headers[1:], serial, 1, 0)
    pages, cur, body, lacing, granule, prev = [], [], 0, 0, 0, None
    for k, (pkt, n) in enumerate(zip(packets, sizes)):
        laces = len(pkt) // 255 + 1
        if cur and (body + len(pkt) > VORBIS_PAGE_BODY or lacing + laces > 255):
            pages.append(build_ogg_page(cur, serial, 2 + len(pages), granule))
            cur, body, lacing = [], 0, 0
        cur.append(pkt)
        body += len(pkt)
        lacing += laces
        granule += 0 if prev is None else prev // 4 + n // 4
        prev = n
    pages.append(build_ogg_page(cur, serial, 2 + len(pages), granule, header_type=4))
    return header, pages


def vorbis_floor0_packets() -> List[bytes]:
    """The crafted floor0 stream's three headers and its audio packets
    (``tests/vorbis_craft.py``, LSP order 8): seeded amplitudes, LSP and
    residue words, one packet with amplitude 0 (an unused channel) and
    one truncated in its residue."""
    from vorbis_craft import build_audio_packet, build_headers

    rng = np.random.RandomState(11)
    pkts = []
    for k in range(VORBIS_FLOOR0_PACKETS):
        amp = int(rng.randint(6, 15)) if k != 3 else 0
        lsp = [int(rng.randint(0, 16)) for _ in range(2)]
        res = [int(rng.randint(0, 16)) for _ in range(32 if k != 5 else 16)]
        pkts.append(build_audio_packet(amp, lsp, res, order=8))
    return list(build_headers(8)) + pkts


def generate_vorbis_fixtures(directory: Path = vorbis_fixtures.FIXTURE_DIR) -> None:
    """Encode the libvorbis clips with the JAX package's
    ``AvEncoder("libvorbis", ...)``, mux them (:func:`_vorbis_ogg`), craft
    the floor0 stream with ``vorbis_craft.ogg_encapsulate`` (one packet a
    page) and write the streams and their index. The stereo clips must
    hold every (previous, current) block-size case, by the JAX package's
    packet parse."""
    from soundkit_tpu.codecs.encoders import AvEncoder
    from soundkit_tpu.codecs.vorbis import split_xiph_extradata
    from soundkit_tpu.codecs.vorbis_core import VorbisSetup
    from vorbis_craft import ogg_encapsulate

    directory.mkdir(parents=True, exist_ok=True)
    index = {}
    for serial, (name, (rate, ch, _)) in enumerate(VORBIS_CLIPS.items(), start=0x5000):
        enc = AvEncoder("libvorbis", rate, ch)
        packets = enc.push_f32(vorbis_clip_pcm(name).reshape(-1)) + enc.flush()
        headers = split_xiph_extradata(enc.extradata)
        setup = VorbisSetup(headers[0], headers[2])
        sizes = [setup.decode_packet_spectrum(p).n for p in packets]
        cases = {(a, b) for a, b in zip(sizes, sizes[1:])}
        if ch == 2:
            n0, n1 = setup.blocksize0, setup.blocksize1
            assert cases == {(n0, n0), (n0, n1), (n1, n0), (n1, n1)}, (name, cases)
        header, pages = _vorbis_ogg(headers, packets, sizes, serial)
        index[name] = dict(rate=rate, channels=ch,
                           blocksizes=[setup.blocksize0, setup.blocksize1], header=len(header),
                           pages=[len(p) for p in pages], packets=len(packets),
                           short_blocks=sizes.count(setup.blocksize0))
        (directory / f"{name}.ogg").write_bytes(header + b"".join(pages))
    crafted = vorbis_floor0_packets()
    data = ogg_encapsulate(crafted)
    setup = VorbisSetup(crafted[0], crafted[2])
    header = sum(len(p) for p in vorbis_fixtures._pages(data)[:3])
    index["floor0"] = dict(rate=setup.sample_rate, channels=setup.channels,
                           blocksizes=[setup.blocksize0, setup.blocksize1], header=header,
                           pages=[len(p) for p in vorbis_fixtures._pages(data)[3:]],
                           packets=VORBIS_FLOOR0_PACKETS, short_blocks=VORBIS_FLOOR0_PACKETS)
    (directory / "floor0.ogg").write_bytes(data)
    (directory / "index.json").write_text(json.dumps(index, indent=1) + "\n")


def silk_resampler_arrays() -> Dict[str, np.ndarray]:
    """The probed resampler plan of every SILK bandwidth, from the JAX
    package's functions (``ops/silk_batch.py``: ``resampler_taps``,
    ``_resample_plan``, ``first_slot_correction``, which probe its
    libswresample-backed ``utils/swr.SilkResampler``): per bandwidth
    ``bw``, ``taps_{bw}`` f64 [R, 16], ``off_{bw}``, ``T_{bw}``,
    ``lead_invalid_{bw}`` and the slot-0 correction ``C_{bw}`` f64
    [960, 48]."""
    from soundkit_tpu.ops import silk_batch as jax_sb

    out = {}
    for bw in range(3):
        taps, off = jax_sb.resampler_taps(bw)
        _, _, T, lead = jax_sb._resample_plan(bw)
        out[f"taps_{bw}"] = np.asarray(taps, np.float64)
        out[f"off_{bw}"] = np.int64(off)
        out[f"T_{bw}"] = np.int64(T)
        out[f"lead_invalid_{bw}"] = np.int64(lead)
        out[f"C_{bw}"] = np.asarray(jax_sb.first_slot_correction(bw), np.float64)
    return out


def generate_silk_resampler_table(path: Path = None) -> None:
    """Write :func:`silk_resampler_arrays` to the port's committed table
    (``soundkit_tpu_torch/data/silk_resampler.npz``)."""
    from soundkit_tpu_torch.ops import silk_batch

    np.savez_compressed(path or silk_batch.TABLE_PATH, **silk_resampler_arrays())


# ---------------------------------------------------------------------------
# host codec fixtures: GSM, AC-3, Ogg Speex, ALAC (CAF, MP4), AIFF / AIFF-C
# ---------------------------------------------------------------------------

HOST_SPEEX = {"speex_nb": (8000, 1, 1.0), "speex_wb": (16000, 1, 1.0),
              "speex_uwb": (32000, 1, 0.5), "speex_nb_stereo": (8000, 2, 1.0)}
HOST_AC3 = {"ac3_mono": (1, 96000, 0.5), "ac3_stereo": (2, 192000, 0.5),
            "ac3_51": (6, 448000, 0.25)}
ALAC_PACKETS = 3
ALAC_FRAMES = 4096
AIFF_RATE, AIFF_SECONDS = 8000, 0.25
# (compression or None for AIFF, bits)
HOST_AIFF = {"aiff_8": (None, 8), "aiff_16": (None, 16), "aiff_24": (None, 24),
             "aiff_32": (None, 32), "aifc_sowt": (b"sowt", 16), "aifc_fl32": (b"fl32", 32),
             "aifc_fl64": (b"fl64", 64), "aifc_ulaw": (b"ulaw", 16), "aifc_alaw": (b"alaw", 16)}


def host_voice(rate: int, seconds: float, channels: int, seed: int) -> np.ndarray:
    """Float samples [n, C] of a voiced, speech-like sound: a glottal
    harmonic series at a wandering pitch, bursts of syllable envelopes,
    breath noise and, in stereo, the second channel panned apart."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    f0 = 120 + 30 * np.sin(2 * np.pi * 1.7 * t) + 10 * np.sin(2 * np.pi * 4.1 * t)
    ph = np.cumsum(2 * np.pi * f0 / rate)
    x = sum(a * np.sin(k * ph) for k, a in ((1, 0.4), (2, 0.25), (3, 0.12), (5, 0.06), (9, 0.02)))
    x = x * (0.3 + 0.7 * np.abs(np.sin(2 * np.pi * 2.3 * t + rng.uniform(0, 3)))) \
        + 0.02 * rng.standard_normal(n) + 0.03 * np.sin(2 * np.pi * min(5000, rate / 3) * t)
    if channels == 1:
        return np.clip(x, -1, 1)[:, None]
    y = 0.6 * x + 0.1 * np.sin(2 * np.pi * 330 * t) + 0.01 * rng.standard_normal(n)
    return np.clip(np.stack([x, y], 1), -1, 1)


def host_music(rate: int, seconds: float, channels: int, seed: int) -> np.ndarray:
    """Float samples [n, C]: a chord per channel under decaying noise hits."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    env = np.zeros(n)
    for o in rng.uniform(0, seconds, int(4 * seconds) + 1):
        m = t >= o
        env[m] += np.exp(-(t[m] - o) / 0.03)
    chans = []
    for c in range(channels):
        f = 110 * 2 ** (c / 4)
        x = sum(0.12 * np.sin(2 * np.pi * f * r * t + c) for r in (1, 1.25, 1.5, 2))
        chans.append(x + rng.standard_normal(n) * 0.15 * env + 0.005 * rng.standard_normal(n))
    return np.clip(np.stack(chans, 1), -1, 1)


def _flip_ac3_blksw(data: bytes, n_frames: int) -> bytes:
    """``data``'s first ``n_frames`` syncframes with their block switch
    flags set: every block of the even frames, blocks 1 and 4 of the odd
    ones (``tests/test_ac3.py``'s patch: it changes the transform only)."""
    from soundkit_tpu.codecs import ac3_core as jax_ac3

    size = 2 * int(jax_ac3._t()["frame_size"][data[4] & 0x3F][data[4] >> 6])
    out = bytearray(data[: size * n_frames])
    for k, off in enumerate(range(0, len(out), size)):
        frame = bytearray(out[off: off + size])
        probe = jax_ac3.Ac3Decoder()
        probe.decode_frame(bytes(frame))
        for b in (range(6) if k % 2 == 0 else (1, 4)):
            p = probe._blk_bitpos[b]
            frame[p >> 3] ^= 0x80 >> (p & 7)
        out[off: off + size] = frame
    return bytes(out)


def _ogg_speex_stream(extradata: bytes, packets: List[bytes]) -> bytes:
    comment = struct.pack("<I", 12) + b"soundkit-tpu" + bytes(4)
    return host_codec_fixtures._ogg_speex(extradata, comment, packets)


def jax_host_decode(name: str, data: bytes, spawn: str) -> list:
    """The JAX package's ``StreamDecoder`` outputs for a clip, by ``spawn``:
    "detect", "gsm_standard", "gsm_microsoft" or "alac"."""
    from soundkit_tpu.codecs.containers import AlacAdapter
    from soundkit_tpu.codecs.telephony import GsmVariant, make_gsm_adapter
    from soundkit_tpu.pipeline.decode_pipeline import StreamDecoder
    from soundkit_tpu.pipeline.output_options import DecodeOptions

    adapter = {"detect": lambda: None, "alac": AlacAdapter,
               "gsm_standard": lambda: make_gsm_adapter(GsmVariant.STANDARD),
               "gsm_microsoft": lambda: make_gsm_adapter(GsmVariant.MICROSOFT)}[spawn]()
    dec = StreamDecoder(DecodeOptions(), adapter)
    return dec.process(data) + dec.process(b"")


def generate_host_codec_fixtures(directory: Path = host_codec_fixtures.FIXTURE_DIR) -> None:
    """Encode the host codecs' clips with the JAX package's ``AvEncoder``
    (libgsm, libgsm_ms, ac3, libspeex, alac), write the AIFF files and the
    MP4 with the port's writers (``tools/host_codec_fixtures.py``), decode
    each through the JAX package's ``StreamDecoder`` and write the index
    and the AC-3 / Speex reference PCM."""
    from soundkit_tpu.codecs.encoders import AvEncoder
    from soundkit_tpu.codecs.g711 import G711Law
    from soundkit_tpu.codecs.g711 import encode_i16 as g711_encode
    from soundkit_tpu.core.audio_types import AudioData
    from soundkit_tpu.demux.caf import mux_caf_alac

    hcf = host_codec_fixtures
    directory.mkdir(parents=True, exist_ok=True)
    clips = {}  # name: (bytes, extension, spawn, extra index fields)

    def encode(codec, rate, channels, pcm, bit_rate=0):
        enc = AvEncoder(codec, rate, channels, bit_rate)
        packets = enc.push_f32(pcm.reshape(-1).astype(np.float32)) + enc.flush()
        return packets, enc

    for seed, (name, codec, spawn) in enumerate((("gsm_standard", "libgsm", "gsm_standard"),
                                                 ("gsm_wav49", "libgsm_ms", "gsm_microsoft")),
                                                start=8100):
        packets, _ = encode(codec, 8000, 1, host_voice(8000, 2.0, 1, seed))
        clips[name] = (b"".join(packets), "gsm", spawn, dict(frame_bytes=len(packets[0])))
    for seed, (name, (ch, bit_rate, seconds)) in enumerate(HOST_AC3.items(), start=8200):
        packets, _ = encode("ac3", 48000, ch, host_music(48000, seconds, ch, seed), bit_rate)
        clips[name] = (b"".join(packets), "ac3", "detect", dict(frame_bytes=len(packets[0])))
    n_frames = len(clips["ac3_stereo"][0]) // clips["ac3_stereo"][3]["frame_bytes"]
    clips["ac3_blksw"] = (_flip_ac3_blksw(clips["ac3_stereo"][0], n_frames), "ac3", "detect",
                          dict(frame_bytes=clips["ac3_stereo"][3]["frame_bytes"]))
    for seed, (name, (rate, ch, seconds)) in enumerate(HOST_SPEEX.items(), start=8300):
        packets, enc = encode("libspeex", rate, ch, host_voice(rate, seconds, ch, seed))
        clips[name] = (_ogg_speex_stream(enc.extradata, packets), "spx", "detect",
                       dict(packets=len(packets)))
    t = np.arange(ALAC_PACKETS * ALAC_FRAMES) / 44100
    pcm = np.stack([0.2 * np.sin(2 * np.pi * f * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t + f))
                    + 1e-4 * np.random.default_rng(8400 + i).standard_normal(t.size)
                    for i, f in enumerate((220.0, 331.0))], 1)
    pcm16 = np.clip(np.round(pcm * 32768), -32768, 32767).astype(np.int16)
    packets, enc = encode("alac", 44100, 2, pcm16.astype(np.float32) / 32768.0)
    assert len(packets) == ALAC_PACKETS, len(packets)
    bits = enc.extradata[12 + 5]  # the cookie's bit depth: 24 (libavcodec encodes from S32P)
    alac = dict(frames_per_packet=ALAC_FRAMES, alac_bits=bits,
                source_sha256=hcf.sha256(pcm16.astype("<i2").tobytes()))
    clips["alac_caf"] = (mux_caf_alac(packets, enc.extradata, 44100, 2, bits, ALAC_FRAMES), "caf",
                         "alac", alac)
    clips["alac_mp4"] = (hcf.mux_mp4("alac", enc.extradata, packets, 44100, 2, ALAC_FRAMES, bits),
                         "m4a", "detect", alac)
    x = host_music(AIFF_RATE, AIFF_SECONDS, 2, 8500) * 0.9
    for name, (comp, bits) in HOST_AIFF.items():
        inter = x.reshape(-1)
        if comp in (b"ulaw", b"alaw"):
            law = G711Law.MU_LAW if comp == b"ulaw" else G711Law.A_LAW
            sound = g711_encode(law, np.round(inter * 32767).astype(np.int16)).tobytes()
        elif comp in (b"fl32", b"fl64"):
            sound = inter.astype(">f4" if comp == b"fl32" else ">f8").tobytes()
        else:
            full = np.clip(np.round(inter * 2.0 ** (bits - 1)), -2 ** (bits - 1),
                           2 ** (bits - 1) - 1).astype(np.int64)
            dt = {8: ">i1", 16: ">i2", 32: ">i4"}.get(bits)
            if comp == b"sowt":
                sound = full.astype("<i2").tobytes()
            elif dt:
                sound = full.astype(dt).tobytes()
            else:  # 24-bit big-endian
                sound = np.stack([(full >> 16) & 255, (full >> 8) & 255, full & 255],
                                 1).astype(np.uint8).tobytes()
        clips[name] = (hcf.build_aiff(2, bits, AIFF_RATE, sound, comp),
                       "aifc" if comp else "aiff", "detect", {})

    index, ref_pcm = {}, {}
    for name, (data, ext, spawn, extra) in clips.items():
        outs = jax_host_decode(name, data, spawn)
        audio = [o for o in outs if isinstance(o, AudioData)]
        assert audio and len(audio) == len(outs), (name, outs)
        pcm_bytes = b"".join(o.data for o in audio)
        a0 = audio[0]
        frames = len(pcm_bytes) // (a0.bits_per_sample // 8) // a0.channel_count
        (directory / f"{name}.{ext}").write_bytes(data)
        index[name] = dict(file=f"{name}.{ext}", spawn=spawn, rate=a0.sampling_rate,
                           channels=a0.channel_count, bits=a0.bits_per_sample,
                           format=a0.audio_format.value, seconds=frames / a0.sampling_rate,
                           pcm_bytes=len(pcm_bytes), sha256=hcf.sha256(pcm_bytes), **extra)
        if name in hcf.REFERENCE_PCM:
            ref_pcm[name] = np.frombuffer(pcm_bytes, "<i2")
    np.savez_compressed(directory / "reference_pcm.npz", **ref_pcm)
    (directory / "index.json").write_text(json.dumps(index, indent=1) + "\n")
    generate_celp_fixtures(directory)  # the synthesized G.729 / AMR-NB clips beside them


# ---------------------------------------------------------------------------
# G.729 and AMR-NB (owned decoders; the JAX package's libavcodec is the
# reference)
# ---------------------------------------------------------------------------

G729_FIELDS = (1, 7, 5, 5, 8, 1, 13, 4, 3, 4, 5, 13, 4, 3, 4)  # L0..L3, P1, P0, C1, ..., GB2


def _pack_msb(values, widths) -> bytes:
    acc, n = 0, 0
    for v, w in zip(values, widths):
        acc = (acc << w) | (int(v) & ((1 << w) - 1))
        n += w
    return acc.to_bytes(n // 8, "big")


def _g729_lag_index(lag: float) -> int:
    """The 8-bit first-subframe index of a pitch lag (1/3 resolution below 85)."""
    if lag < 85:
        return int(np.clip(round(3 * lag) - 58, 0, 196))
    return int(np.clip(round(lag) + 112, 197, 255))


def g729_speech_frames(n: int, rng, bad_parity=()) -> List[bytes]:
    """``n`` G.729 frames packed from slow trajectories: the lag drifting over
    40-140 samples, mid-range gains, LSF indices held 4-8 frames; the frames
    in ``bad_parity`` carry the wrong parity bit."""
    frames, lsf, hold = [], None, 0
    phase = rng.uniform(0, 2 * np.pi)
    for i in range(n):
        if hold == 0:
            lsf = tuple(rng.integers(0, 1 << w) for w in G729_FIELDS[:4])
            hold = int(rng.integers(4, 9))
        hold -= 1
        lag = 90 + 50 * np.sin(2 * np.pi * i / 170 + phase)
        p1 = _g729_lag_index(lag)
        p0 = (bin(p1 >> 2).count("1") & 1) ^ 1 ^ (1 if i in bad_parity else 0)
        sub = [(rng.integers(0, 1 << 13), rng.integers(0, 16), rng.integers(2, 6),
                rng.integers(5, 11)) for _ in range(2)]
        p2 = int(np.clip(15 + rng.integers(-2, 3), 0, 31))
        frames.append(_pack_msb((*lsf, p1, p0, *sub[0], p2, *sub[1]), G729_FIELDS))
    return frames


def _amr_order(mode: int):
    """(size, byte offset, bits) of each field of an AMR-NB mode's bit order,
    from the port's extracted tables."""
    t = extract_celp_tables.load("amrnb")[f"order_MODE_{celp_fixtures.AMR_MODES[mode]}"]
    out, i = [], 0
    while t[i]:
        size, off = int(t[i]), int(t[i + 1])
        out.append((size, off, [int(b) for b in t[i + 2:i + 2 + size]]))
        i += 2 + size
    return out


def amr_pack(mode: int, fields: dict, quality: int = 1) -> bytes:
    """An AMR-NB frame (TOC and payload) of ``mode`` with the field values
    ``fields`` ({byte offset: value}; the rest zero), packed through the
    mode's bit order."""
    payload = bytearray(amr_nb_frame_len(mode << 3))
    for size, off, bits in _amr_order(mode):
        v = fields.get(off, 0)
        for k, bit in enumerate(bits):
            if (v >> (size - 1 - k)) & 1:
                payload[bit >> 3] |= 1 << (bit & 7)
    return bytes([(mode << 3) | (quality << 2)]) + bytes(payload)


def amr_speech_frames(modes, rng) -> List[bytes]:
    """One frame a mode of ``modes``, its fields from slow trajectories: the
    absolute lags drifting over 40-140 samples, the relative ones near the
    last lag, mid-range gain indices, LSF indices held 4-8 frames, random
    pulses."""
    frames, lsf, hold = [], {}, 0
    phase = rng.uniform(0, 2 * np.pi)
    for i, mode in enumerate(modes):
        order = _amr_order(mode)
        width = {off: size for size, off, _ in order}
        if hold == 0:
            lsf = {off: int(rng.integers(0, 1 << width.get(off, 0))) for off in range(0, 10, 2)}
            hold = int(rng.integers(4, 9))
        hold -= 1
        lag = 90 + 50 * np.sin(2 * np.pi * i / 170 + phase)
        fields = {off: v for off, v in lsf.items() if off in width}
        for s in range(4):
            base = 10 + 26 * s
            w = width.get(base, 0)
            if mode == 7 and s in (0, 2):  # 9 bits, 1/6 resolution
                fields[base] = (int(round(6 * lag)) - 105 if lag < 94 else int(round(lag)) + 368)
            elif s == 0 or (s == 2 and mode > 1):  # 8 bits, 1/3 resolution
                fields[base] = _g729_lag_index(lag)
            else:  # relative to the last lag: the middle of its range
                fields[base] = (1 << w) // 2 - 1 + int(rng.integers(-1, 2))
            wg = width.get(base + 2, 0)
            if wg:
                fields[base + 2] = int(rng.integers((1 << wg) // 4, 3 * (1 << wg) // 4))
            if width.get(base + 4):
                fields[base + 4] = int(rng.integers(10, 22))
            for k in range(10):
                wp = width.get(base + 6 + 2 * k, 0)
                if wp:
                    fields[base + 6 + 2 * k] = int(rng.integers(0, 1 << wp))
        frames.append(amr_pack(mode, fields))
    return frames


def amr_random_frames(modes, rng) -> List[bytes]:
    return [bytes([(m << 3) | 4]) +
            rng.integers(0, 256, amr_nb_frame_len(m << 3), dtype=np.uint8).tobytes()
            for m in modes]


def celp_clip_bytes() -> Dict[str, bytes]:
    """The G.729 and AMR-NB clips, from numpy seeds."""
    clips = {}
    rng = np.random.default_rng(8900)
    data = rng.integers(0, 256, 10 * 300, dtype=np.uint8)
    for f in rng.integers(0, 300, 12):
        data[10 * f:10 * f + 10] = 0
    clips["g729_random"] = data.tobytes()
    clips["g729_speech"] = b"".join(g729_speech_frames(400, np.random.default_rng(8901)))
    rng = np.random.default_rng(8902)
    frames = g729_speech_frames(250, rng, bad_parity={20, 21, 77, 140, 141, 142, 200})
    for start, run in ((30, 1), (60, 3), (100, 10), (180, 2), (248, 2)):
        for f in range(start, start + run):
            frames[f] = bytes(10)
    clips["g729_edges"] = b"".join(frames) + rng.integers(0, 256, 7, dtype=np.uint8).tobytes()

    rng = np.random.default_rng(8910)
    clips["amrnb_random"] = AMR_MAGIC + b"".join(
        amr_random_frames(rng.integers(0, 8, 150), rng))
    for m, mode in enumerate(celp_fixtures.AMR_MODES):
        clips[f"amrnb_{mode}"] = AMR_MAGIC + b"".join(
            amr_speech_frames([m] * 100, np.random.default_rng(8920 + m)))
    rng = np.random.default_rng(8930)
    clips["amrnb_switch"] = AMR_MAGIC + b"".join(
        amr_speech_frames(rng.integers(0, 8, 150), rng))

    rng = np.random.default_rng(8940)
    parts = []
    for i, m in enumerate(rng.integers(0, 8, 110)):
        frame = amr_speech_frames([int(m)], rng)[0]
        kind = i % 11
        if kind == 1:
            frame = bytes([(8 << 3) | 4]) + rng.integers(0, 256, 5, dtype=np.uint8).tobytes()  # SID
        elif kind == 3:
            frame = bytes([(15 << 3) | 4])  # NO_DATA
        elif kind == 5:
            frame = bytes([frame[0] & ~4]) + frame[1:]  # quality bit 0
        elif kind == 7:
            frame = bytes([frame[0] | 0x80]) + frame[1:]  # bit 7 set
        elif kind == 9:
            frame = bytes([(int(rng.integers(9, 15)) << 3) | 4]) + frame  # a byte to resync past
        parts.append(frame)
    tail = amr_speech_frames([7], rng)[0][:20]
    clips["amrnb_edges"] = AMR_MAGIC + b"".join(parts) + tail
    rng = np.random.default_rng(8950)
    clips["amrnb_nomagic"] = b"".join(amr_speech_frames(rng.integers(0, 8, 100), rng)) + \
        amr_speech_frames([4], rng)[0][:9]
    return clips


def jax_celp_decode(name: str, data: bytes) -> list:
    """The JAX package's ``StreamDecoder`` outputs for a G.729 or AMR-NB
    stream (libavcodec's decoders behind its framing)."""
    from soundkit_tpu.codecs.telephony import make_amr_adapter, make_g729_adapter
    from soundkit_tpu.pipeline.decode_pipeline import StreamDecoder
    from soundkit_tpu.pipeline.output_options import DecodeOptions

    adapter = make_g729_adapter() if name.startswith("g729") else make_amr_adapter()
    dec = StreamDecoder(DecodeOptions(), adapter)
    return dec.process(data) + dec.process(b"")


def generate_celp_fixtures(directory: Path = host_codec_fixtures.FIXTURE_DIR) -> None:
    """Write the G.729 and AMR-NB clips, decode each through the JAX
    package and merge their entries into the host codecs' index and
    reference PCM (the other clips' entries are kept)."""
    from soundkit_tpu.core.audio_types import AudioData

    hcf = host_codec_fixtures
    index = json.loads((directory / "index.json").read_text())
    with np.load(directory / "reference_pcm.npz") as z:
        ref_pcm = {k: z[k] for k in z.files}
    for name, data in celp_clip_bytes().items():
        outs = jax_celp_decode(name, data)
        audio = [o for o in outs if isinstance(o, AudioData)]
        assert audio and len(audio) == len(outs), (name, outs)
        pcm_bytes = b"".join(o.data for o in audio)
        a0 = audio[0]
        ext = "g729" if name.startswith("g729") else "amr"
        (directory / f"{name}.{ext}").write_bytes(data)
        index[name] = dict(file=f"{name}.{ext}", spawn=celp_fixtures.kind(name),
                           rate=a0.sampling_rate, channels=a0.channel_count,
                           bits=a0.bits_per_sample, format=a0.audio_format.value,
                           seconds=len(pcm_bytes) // 2 / a0.sampling_rate,
                           pcm_bytes=len(pcm_bytes), sha256=hcf.sha256(pcm_bytes))
        ref_pcm[name] = np.frombuffer(pcm_bytes, "<i2")
    np.savez_compressed(directory / "reference_pcm.npz", **ref_pcm)
    (directory / "index.json").write_text(json.dumps(index, indent=1) + "\n")


def celp_jax_f32(name: str, data: bytes = None) -> np.ndarray:
    """The JAX package's float32 decode of a G.729 or AMR-NB clip
    (``decode_f32`` of its decoder, then ``flush``)."""
    from soundkit_tpu.codecs.telephony import AmrNbDecoder, G729Decoder

    data = host_codec_fixtures.clip_bytes(name) if data is None else data
    dec = G729Decoder() if name.startswith("g729") else AmrNbDecoder()
    return np.concatenate([dec.decode_f32(data), dec.flush()])


def celp_random_streams(codec: str, streams: int, seed: int) -> List[bytes]:
    """``streams`` seeded random G.729 or AMR-NB streams of 50 frames each:
    G.729 uniform random 10-byte frames, one in ten erased; AMR-NB the
    magic and random payloads of random modes behind valid TOC bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(streams):
        if codec == "g729":
            data = rng.integers(0, 256, (50, 10), dtype=np.uint8)
            data[rng.random(50) < 0.1] = 0
            out.append(data.tobytes())
        else:
            out.append(AMR_MAGIC + b"".join(amr_random_frames(rng.integers(0, 8, 50), rng)))
    return out


def celp_random_sweep(codec: str, streams: int = 140, seed: int = 8960) -> Dict[str, float]:
    """The port's ``G729Decoder`` / ``AmrNbDecoder`` against the JAX
    package's (libavcodec) on :func:`celp_random_streams`, whole stream then
    flush: the streams, the worst float32 SNR in dB, the worst int16
    difference and the streams not equal in float32. ``tests/test_torch_celp.py``
    holds it; run it alone as ``JAX_PLATFORMS=cpu python -c "import sys;
    sys.path.insert(0, 'tests'); import torch_port_helpers as h;
    print(h.celp_random_sweep('amrnb'))"`` from the repository's root."""
    from soundkit_tpu.codecs import telephony as jax_tel
    from soundkit_tpu_torch.codecs import telephony

    worst_snr, worst_lsb, unequal = float("inf"), 0, 0
    for data in celp_random_streams(codec, streams, seed):
        decs = (telephony.G729Decoder(), jax_tel.G729Decoder()) if codec == "g729" else \
            (telephony.AmrNbDecoder(), jax_tel.AmrNbDecoder())
        got, want = (np.concatenate([d.decode_f32(data), d.flush()]) for d in decs)
        assert got.shape == want.shape, (got.shape, want.shape)
        if not np.array_equal(got, want):
            unequal += 1
            worst_snr = min(worst_snr, snr_db(got, want))
        worst_lsb = max(worst_lsb, int(np.abs(telephony.f32_to_i16(got).astype(np.int32)
                                              - jax_tel.f32_to_i16(want).astype(np.int32)).max()))
    return dict(streams=streams, worst_snr_db=worst_snr, worst_lsb=worst_lsb, unequal=unequal)


def jax_owned_aac_i16(asc: bytes, aus: List[bytes]) -> bytes:
    """The JAX package's owned decode of raw access units
    (``simple.AacLcStreamDecoder``), converted to int16 as the ADTS path
    converts (float32, then ``f32_to_i16``): little-endian bytes."""
    from soundkit_tpu.codecs.avdec import f32_to_i16
    from soundkit_tpu.simple import AacLcStreamDecoder

    dec = AacLcStreamDecoder(asc)
    return b"".join(f32_to_i16(dec.decode_interleaved(au).astype(np.float32)).astype("<i2").tobytes()
                    for au in aus)


def jax_owned_opus_i16(head: bytes, packets: List[bytes]) -> bytes:
    """The JAX package's owned Opus decode (``codecs/opus._OpusCore`` with
    the OpusHead: pre-skip and gain) of ``packets``, int16 bytes."""
    from soundkit_tpu.codecs.avdec import f32_to_i16
    from soundkit_tpu.codecs.opus import OpusHead, _OpusCore

    core = _OpusCore(OpusHead.parse(head))
    return b"".join(f32_to_i16(core.decode_packet_f32(p)).astype("<i2").tobytes() for p in packets)


def jax_container_pcm(name: str) -> bytes:
    """The JAX package's decode of a decodable container case: its owned
    AAC-LC (M4A, LATM) and Opus decoders on the case's units, its
    ``WebmAdapter`` (through ``StreamDecoder``) for WebM Vorbis."""
    cf = container_fixtures
    config, units = cf.units(name)
    if name in cf.M4A or name in cf.LATM:
        return jax_owned_aac_i16(config, units)
    if name == "webm_vorbis":
        from soundkit_tpu.core.audio_types import AudioData
        from soundkit_tpu.pipeline.decode_pipeline import StreamDecoder

        dec = StreamDecoder()
        outs = dec.process(cf.build(name)) + dec.process(b"")
        assert all(isinstance(o, AudioData) for o in outs), outs
        return b"".join(o.data for o in outs)
    return jax_owned_opus_i16(config, units)


def jax_track_events(data: bytes, chunk: int = 0) -> list:
    from soundkit_tpu.demux.audio_demux import AudioTrackDemuxer

    return container_fixtures.demux_events(AudioTrackDemuxer.new_auto(), data, chunk)


def generate_container_index(directory: Path = container_fixtures.FIXTURE_DIR) -> None:
    """Build every container case (``tools/container_fixtures.py``), decode
    the decodable ones with the JAX package's owned decoders, demux the
    MP4, WebM and MPEG-TS ones with its ``AudioTrackDemuxer``, and write
    the index and the reference PCM of ``webm_opus_silk``'s first second."""
    cf = container_fixtures
    directory.mkdir(parents=True, exist_ok=True)
    index, ref_pcm = {}, {}
    for name in cf.CASES:
        data = cf.build(name)
        e = dict(bytes=len(data), sha256_bytes=cf.sha256(data),
                 spawn="demux" if name in cf.TS else "latm" if name in cf.LATM else "detect")
        if name in cf.DECODED:
            config, units = cf.units(name)
            pcm = jax_container_pcm(name)
            if name in cf.M4A or name in cf.LATM:
                info = cf._asc_info(config)
                rate, channels = info.sample_rate, info.channels
            elif name == "webm_vorbis":
                rate, channels = 44100, 2
            else:
                rate, channels = 48000, config[9]
            e.update(rate=rate, channels=channels, units=len(units),
                     seconds=len(pcm) // 2 // channels / rate, pcm_bytes=len(pcm),
                     sha256=cf.sha256(pcm))
            if name in cf.REFERENCE_PCM:
                ref_pcm[name] = np.frombuffer(pcm, "<i2")[:rate * channels]
        if name not in cf.LATM:
            e["events"] = cf.events_digest(jax_track_events(data))
        index[name] = e
    np.savez_compressed(directory / "reference_pcm.npz", **ref_pcm)
    (directory / "index.json").write_text(json.dumps(index, indent=1) + "\n")


# ---------------------------------------------------------------------------
# MPEG audio Layer I / II (tools/mpa_fixtures.py)
# ---------------------------------------------------------------------------

_MPA_VERSION_BITS = {"1": 3, "2": 2, "2.5": 0}
_MPA_RATES = {"1": (44100, 48000, 32000), "2": (22050, 24000, 16000), "2.5": (11025, 12000, 8000)}
_MPA_MODES = {"stereo": 0, "joint": 1, "dual": 2, "mono": 3}


class _BitWriter:
    def __init__(self) -> None:
        self.bits: List[int] = []

    def put(self, value: int, width: int) -> None:
        self.bits.extend((int(value) >> (width - 1 - k)) & 1 for k in range(width))


def _crc16(bits: List[int]) -> int:
    """CRC-16 (x^16 + x^15 + x^2 + 1, preset 0xFFFF) of a bit sequence,
    as ISO/IEC 11172-3 protects a frame's header and side bits."""
    crc = 0xFFFF
    for b in bits:
        top = (crc >> 15) & 1
        crc = (crc << 1) & 0xFFFF
        if top ^ b:
            crc ^= 0x8005
    return crc


def mpa_frames(seed: int, layer: int, version: str, rate: int, mode: str, kbps: int,
               n_frames: int, *, mode_exts=(0,), crc: bool = False, bad_crc: bool = False) -> bytes:
    """``n_frames`` Layer I or II frames written from seeded random side
    information and sample codes (the test side's frame writer).

    Each frame draws an allocation, scfsi and scalefactors, then cuts
    allocations until its codes fit its bytes; the rest of the frame is
    zero (ancillary data). The padding bit follows the frame-length
    accumulator of an encoder (set where the nominal length has a
    fraction, at 44.1 kHz and its halves). A joint-stereo frame takes its
    mode extension from ``mode_exts`` in turn. With ``crc`` the CRC word
    covers the header's last 16 bits and the allocation (and Layer II's
    scfsi) bits; ``bad_crc`` writes it inverted."""
    rng = np.random.default_rng(seed)
    tables = dict(np.load(Path(mpa_fixtures.__file__).resolve().parents[1] / "data"
                          / "mpa_tables.npz"))
    lsf = version != "1"
    kb_row = list(tables["bitrate_tab"][int(lsf), layer - 1])
    br_idx = kb_row.index(kbps)
    sr_idx = _MPA_RATES[version].index(rate)
    nch = 1 if mode == "mono" else 2
    # Layer II: the allocation table (ISO/IEC 11172-3 Table 3-B.2 by rate
    # and bit rate per channel; ISO/IEC 13818-3 Table B.1 for LSF)
    if layer == 2:
        per_ch = kbps // nch
        if lsf:
            tab = 4
        elif (rate == 48000 and per_ch >= 56) or 56 <= per_ch <= 80:
            tab = 0
        elif rate != 48000 and per_ch >= 96:
            tab = 1
        elif rate != 32000 and per_ch <= 48:
            tab = 2
        else:
            tab = 3
        sblimit = int(tables["sblimit"][tab])
        alloc_tab = tables[f"alloc_{tab}"]
        nbal, offs = [], []
        j = 0
        for _ in range(sblimit):
            nbal.append(int(alloc_tab[j]))
            offs.append(j)
            j += 1 << int(alloc_tab[j])
    else:
        sblimit = 32
    unit = 12000 if layer == 1 else 144000
    acc = 0
    out = bytearray()
    for f in range(n_frames):
        acc += kbps * unit % rate
        padding = 1 if acc >= rate else 0
        acc -= rate * padding
        size = ((kbps * unit // rate + padding) * 4) if layer == 1 else kbps * unit // rate + padding
        mode_ext = mode_exts[f % len(mode_exts)] if mode == "joint" else 0
        bound = min((mode_ext + 1) * 4, sblimit) if mode == "joint" else sblimit
        entries = [(i, c) for i in range(bound) for c in range(nch)] + \
                  [(i, 0) for i in range(bound, sblimit)]
        if layer == 1:
            alloc = {e: int(rng.integers(0, 15)) if rng.random() < 0.8 else 0 for e in entries}
        else:
            alloc = {e: int(rng.integers(0, 1 << nbal[e[0]])) if rng.random() < 0.8 else 0
                     for e in entries}

        def klass(e):  # Layer II: (code bits, steps, grouped) of an entry
            q = int(tables[f"alloc_{tab}"][offs[e[0]] + alloc[e]])
            bits, steps = int(tables["quant_bits"][q]), int(tables["quant_steps"][q])
            return abs(bits), steps, bits < 0

        def coded(e):  # the (subband, channel) pairs an entry codes
            return [(e[0], c) for c in range(nch)] if e[0] >= bound else [e]

        def cost():
            side = 32 + 16 * crc
            if layer == 1:
                side += 4 * len(entries)
                side += sum(6 * len(coded(e)) for e in entries if alloc[e])
                return side + sum(12 * (alloc[e] + 1) for e in entries if alloc[e])
            side += sum(nbal[e[0]] for e in entries)
            side += sum(20 * len(coded(e)) for e in entries if alloc[e])  # scfsi + <= 3 sf
            body = 0
            for e in entries:
                if alloc[e]:
                    bits, _, grouped = klass(e)
                    body += 12 * (bits if grouped else 3 * bits)
            return side + body

        while cost() > size * 8:
            live = [e for e in entries if alloc[e]]
            e = live[int(rng.integers(0, len(live)))]
            alloc[e] = alloc[e] - 1 if rng.random() < 0.7 else 0
        w = _BitWriter()
        header = (0x7FF << 21) | (_MPA_VERSION_BITS[version] << 19) | ((4 - layer) << 17) \
            | ((0 if crc else 1) << 16) | (br_idx << 12) | (sr_idx << 10) | (padding << 9) \
            | (_MPA_MODES[mode] << 6) | (mode_ext << 4)
        w.put(header, 32)
        if crc:
            w.put(0, 16)  # filled in below
        protected = len(w.bits)
        for e in entries:
            w.put(alloc[e], 4 if layer == 1 else nbal[e[0]])
        pairs = [p for e in entries if alloc[e] for p in coded(e)]
        pair_alloc = {p: alloc[e] for e in entries for p in coded(e)}
        pairs = sorted(pairs)  # subband-major, channel-minor
        sf = {p: np.clip(rng.integers(12 + p[0] // 2, 36 + p[0] // 2, size=3), 0, 62) for p in pairs}
        if layer == 2:
            scfsi = {p: int(rng.integers(0, 4)) for p in pairs}
            for p in pairs:
                w.put(scfsi[p], 2)
        crc_end = len(w.bits)
        if layer == 1:
            for p in pairs:
                w.put(sf[p][0], 6)
        else:
            for p in pairs:
                a, b, c = (int(x) for x in sf[p])
                vals = {0: (a, b, c), 1: (a, c), 2: (a,), 3: (a, c)}[scfsi[p]]
                for v in vals:
                    w.put(v, 6)
        granules = 12 if layer == 1 else 12
        for _g in range(granules):
            for e in entries:
                if not alloc[e]:
                    continue
                if layer == 1:
                    bits = alloc[e] + 1
                    w.put(int(rng.integers(0, (1 << bits) - 1)), bits)
                    continue
                bits, steps, grouped = klass(e)
                codes = rng.integers(0, steps, size=3)
                if grouped:
                    w.put(int(codes[0] + steps * codes[1] + steps * steps * codes[2]), bits)
                else:
                    for cde in codes:
                        w.put(int(cde), bits)
        assert len(w.bits) <= size * 8, (len(w.bits), size * 8, pair_alloc)
        if crc:
            word = _crc16(w.bits[16:32] + w.bits[protected:crc_end]) ^ (0xFFFF if bad_crc else 0)
            w.bits[32:48] = [(word >> (15 - k)) & 1 for k in range(16)]
        bits = w.bits + [0] * (size * 8 - len(w.bits))
        out += np.packbits(np.array(bits, np.uint8)).tobytes()
    return bytes(out)


#: the encoder clips: (codec, rate, channels, bit rate, frames)
MPA_ENCODED = {
    "l2_48_stereo_192": ("mp2", 48000, 2, 192000, 10),
    "l2_48_mono_48": ("mp2", 48000, 1, 48000, 8),
    "l2_44_stereo_192": ("mp2", 44100, 2, 192000, 8),
    "l2_44_mono_64": ("mp2", 44100, 1, 64000, 8),
    "l2_32_stereo_64": ("mp2", 32000, 2, 64000, 6),
    "l2_32_mono_112": ("mp2", 32000, 1, 112000, 6),
    "l2_lsf16_mono_32": ("mp2", 16000, 1, 32000, 5),
    "l2_lsf22_mono_64": ("mp2", 22050, 1, 64000, 8),
    "l2_lsf24_stereo_96": ("mp2", 24000, 2, 96000, 5),
    "l2_twolame_48_stereo_128": ("libtwolame", 48000, 2, 128000, 8),
}
#: the written clips: (layer, version, rate, mode, kbit/s, frames, options)
MPA_WRITTEN = {
    "l1_48_stereo_384": (1, "1", 48000, "stereo", 384, 24, {}),
    "l1_44_mono_crc": (1, "1", 44100, "mono", 192, 16, dict(crc=True)),
    "l1_lsf24_stereo_128": (1, "2", 24000, "stereo", 128, 12, {}),
    "l1_48_joint_256": (1, "1", 48000, "joint", 256, 16, dict(mode_exts=(0, 1, 2, 3))),
    "l2_48_joint_192": (2, "1", 48000, "joint", 192, 8, dict(mode_exts=(0, 1, 2, 3))),
    "l2_lsf24_joint_96": (2, "2", 24000, "joint", 96, 4, dict(mode_exts=(3, 2, 1, 0))),
    "l2_48_dual_256": (2, "1", 48000, "dual", 256, 6, {}),
    "l2_44_stereo_crc_128": (2, "1", 44100, "stereo", 128, 8, dict(crc=True)),
    "l2_48_stereo_badcrc_160": (2, "1", 48000, "stereo", 160, 4, dict(crc=True, bad_crc=True)),
    "l2_44_padded_160": (2, "1", 44100, "stereo", 160, 10, {}),
    "l2_mpeg25_12_mono_32": (2, "2.5", 12000, "mono", 32, 4, {}),
}


def jax_mpa_f32(data: bytes) -> tuple:
    """(interleaved float32 PCM, rate, channels) of the JAX package's
    ``Mp3Decoder`` (libavcodec for Layer I / II) on a whole stream."""
    from soundkit_tpu.codecs.mp3 import Mp3Decoder

    dec = Mp3Decoder()
    pcm = np.concatenate([dec.decode_f32(data), dec.flush_f32()]).astype(np.float32)
    return pcm, dec.sample_rate, dec.channels


def generate_mpa_fixtures(directory: Path = mpa_fixtures.FIXTURE_DIR) -> None:
    """Encode the Layer II clips with the JAX package's ``AvEncoder``, write
    the others with :func:`mpa_frames`, decode each with the JAX package's
    ``Mp3Decoder`` and write the index and the smoke clips' PCM."""
    from soundkit_tpu.codecs.encoders import AvEncoder

    directory.mkdir(parents=True, exist_ok=True)
    index, ref = {}, {}
    clips = {}
    for seed, (name, (codec, rate, ch, bit_rate, n_frames)) in enumerate(MPA_ENCODED.items(),
                                                                        start=8600):
        enc = AvEncoder(codec, rate, ch, bit_rate)
        pcm = host_music(rate, (n_frames + 2) * 1152 / rate, ch, seed) * 0.8
        data = b"".join(enc.push_f32(pcm.reshape(-1).astype(np.float32)) + enc.flush())
        frames = mpa_fixtures.split_frames(data)[:n_frames]
        clips[name] = (b"".join(frames), dict(origin=codec, bit_rate=bit_rate))
    for seed, (name, (layer, version, rate, mode, kbps, n, opts)) in enumerate(
            MPA_WRITTEN.items(), start=8700):
        clips[name] = (mpa_frames(seed, layer, version, rate, mode, kbps, n, **opts),
                       dict(origin="writer", bit_rate=kbps * 1000, **{
                           k: (list(v) if isinstance(v, tuple) else v) for k, v in opts.items()}))
    for name, (data, extra) in clips.items():
        frames = mpa_fixtures.split_frames(data)
        h = data[:4]
        version = {3: "1", 2: "2", 0: "2.5"}[(h[1] >> 3) & 3]
        pcm, rate, ch = jax_mpa_f32(data)
        (directory / f"{name}.mp{4 - ((h[1] >> 1) & 3)}").write_bytes(data)
        index[name] = dict(file=f"{name}.mp{4 - ((h[1] >> 1) & 3)}", sha256=mpa_fixtures.sha256(data),
                           layer=4 - ((h[1] >> 1) & 3), version=version,
                           mode=["stereo", "joint", "dual", "mono"][h[3] >> 6], rate=rate,
                           channels=ch, frames=len(frames), samples=int(pcm.size),
                           pcm_sha256=mpa_fixtures.sha256(pcm.tobytes()), **extra)
        if name in mpa_fixtures.SMOKE:
            ref[name] = pcm
    np.savez_compressed(directory / "reference_pcm.npz", **ref)
    (directory / "index.json").write_text(json.dumps(index, indent=1) + "\n")


# ---------------------------------------------------------------------------
# the libopus oracle, and the multistream Opus fixtures
# ---------------------------------------------------------------------------

def libopus_decode(packets, rate: int, channels: int) -> np.ndarray:
    """libopus's float decode of single-stream ``packets`` at ``rate``
    (8000, 12000, 16000, 24000 or 48000 Hz): [n, channels] float32, no
    pre-skip taken off. At a SILK stream's internal rate this is the SILK
    core's own output."""
    import ctypes

    op = libopus()
    err = ctypes.c_int(0)
    dec = ctypes.c_void_p(op.opus_decoder_create(rate, channels, ctypes.byref(err)))
    assert err.value == 0 and dec.value
    try:
        buf = np.zeros(5760 * channels, np.float32)
        out = []
        for p in packets:
            n = op.opus_decode_float(dec, p, len(p), buf.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), 5760 * rate // 48000, 0)
            assert n > 0, n
            out.append(buf[:n * channels].reshape(n, channels).copy())
    finally:
        op.opus_decoder_destroy(dec)
    return np.concatenate(out)


def libopus_ms_decode(head: bytes, packets) -> np.ndarray:
    """libopus's ``opus_multistream_decode_float`` of a multistream
    stream: [n, channels] float32 in the head's (Vorbis) channel order,
    neither pre-skip nor output gain applied."""
    import ctypes

    op = libopus()
    ch, n_streams, coupled = head[9], head[19], head[20]
    err = ctypes.c_int(0)
    dec = ctypes.c_void_p(op.opus_multistream_decoder_create(
        48000, ch, n_streams, coupled, bytes(head[21:21 + ch]), ctypes.byref(err)))
    assert err.value == 0 and dec.value, err.value
    try:
        buf = np.zeros(5760 * ch, np.float32)
        out = []
        for p in packets:
            n = op.opus_multistream_decode_float(dec, p, len(p), buf.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), 5760, 0)
            assert n > 0, n
            out.append(buf[:n * ch].reshape(n, ch).copy())
    finally:
        op.opus_multistream_decoder_destroy(dec)
    return np.concatenate(out)


#: multistream clip: (channels, family, (streams, coupled, table) or None
#: for the surround encoder's, application, total bit rate, seconds,
#: packet frame sizes (cycled), VBR a packet (cycled), pre-skip (None: the
#: encoder's lookahead), output gain, per-stream (mode, bandwidth) or None)
OPUS_MS_CLIPS = {
    "surround51": (6, 1, None, 2049, 256000, 0.6, (960,), (1,), None, 0, None),
    "surround71": (8, 1, None, 2049, 384000, 0.6, (960,), (1,), None, 0, None),
    "three_40ms": (3, 1, None, 2049, 160000, 1.0, (1920, 1920, 2880, 960, 1920, 2880),
                   (1, 0, 1, 1, 0, 0, 1), None, 0, None),
    "ambisonic_foa": (4, 2, (4, 0, (0, 1, 2, 3)), 2049, 192000, 0.6, (960,), (1,), None, 0,
                      None),
    "voip255": (5, 255, (2, 1, (255, 0, 1, 2, 2)), 2048, 64000, 1.0, (960,), (1,), None, 0,
                ((1001, 1105), (1000, 1103))),
    "surround51_gain": (6, 1, None, 2049, 192000, 0.6, (960,), (1,), 1500, -1536, None),
}
def opus_ms_clip_pcm(name: str) -> np.ndarray:
    """Float32 [n, channels] at 48 kHz: a tone a channel (the LFE of 5.1
    and 7.1 a 60 Hz one) under seeded noise bursts, or for the VoIP clip a
    synthetic voice a channel, each of its own pitch."""
    ch, family, _layout, app, _rate, seconds = OPUS_MS_CLIPS[name][:6]
    seed = 9100 + list(OPUS_MS_CLIPS).index(name)
    rng = np.random.default_rng(seed)
    n = int(48000 * seconds) + 2880
    t = np.arange(n) / 48000
    if app == 2048:
        chans = []
        for c in range(ch):
            f0 = (120 + 35 * c) * (1 + 0.12 * np.sin(2 * np.pi * (0.6 + 0.2 * c) * t))
            ph = 2 * np.pi * np.cumsum(f0) / 48000
            x = sum(np.sin(h * ph) / h ** 0.8 for h in range(1, 30)) * 0.07
            env = (np.sin(2 * np.pi * (2.0 + 0.3 * c) * t + c) > -0.4).astype(float)
            chans.append(x * env + 0.01 * rng.standard_normal(n))
        return np.stack(chans, 1).astype(np.float32)
    lfe = {6: 5, 8: 7}.get(ch) if family == 1 else None
    env = np.zeros(n)
    for o in rng.uniform(0, seconds, int(6 * seconds) + 1):
        m = t >= o
        env[m] += np.exp(-(t[m] - o) / 0.04)
    chans = []
    for c in range(ch):
        if c == lfe:
            chans.append(0.3 * np.sin(2 * np.pi * opus_ms_fixtures.LFE_TONE * t))
            continue
        tone = 0.2 * np.sin(2 * np.pi * opus_ms_fixtures.TONES[c] * t + c)
        chans.append(tone + 0.05 * rng.standard_normal(n) * env + 0.004 * rng.standard_normal(n))
    return np.stack(chans, 1).astype(np.float32)


def libopus_ms_packets(name: str):
    """(packets, (streams, coupled, table), lookahead) of clip ``name`` by
    libopus's multistream encoder: the surround encoder where the clip
    names no layout, the generic one otherwise, each stream's mode and
    bandwidth forced where the clip names them."""
    import ctypes

    ch, family, layout, app, bit_rate, seconds, sizes, vbr, _pre, _gain, modes = \
        OPUS_MS_CLIPS[name]
    op = libopus()
    err = ctypes.c_int(0)
    if layout is None:
        n_streams, coupled = ctypes.c_int(0), ctypes.c_int(0)
        table = ctypes.create_string_buffer(ch)
        enc = op.opus_multistream_surround_encoder_create(
            48000, ch, family, ctypes.byref(n_streams), ctypes.byref(coupled), table, app,
            ctypes.byref(err))
        layout = (n_streams.value, coupled.value, tuple(table.raw[:ch]))
    else:
        enc = op.opus_multistream_encoder_create(48000, ch, layout[0], layout[1],
                                                 bytes(layout[2]), app, ctypes.byref(err))
    assert err.value == 0 and enc, (name, err.value)
    enc = ctypes.c_void_p(enc)

    def ctl(req, v):
        assert op.opus_multistream_encoder_ctl(enc, ctypes.c_int(req), ctypes.c_int(v)) == 0, \
            (name, req, v)

    try:
        ctl(4002, bit_rate)
        for s, (mode, bw) in enumerate(modes or ()):
            sub = ctypes.c_void_p(0)
            assert op.opus_multistream_encoder_ctl(enc, ctypes.c_int(5120), ctypes.c_int(s),
                                                   ctypes.byref(sub)) == 0
            for req, v in ((4024, 3001), (11002, mode), (4004, bw), (4008, bw)):
                assert op.opus_encoder_ctl(sub, ctypes.c_int(req), ctypes.c_int(v)) == 0
        lookahead = ctypes.c_int(0)
        assert op.opus_multistream_encoder_ctl(enc, ctypes.c_int(4027),
                                               ctypes.byref(lookahead)) == 0
        pcm = opus_ms_clip_pcm(name)
        total = int(48000 * seconds)
        packets, pos, k = [], 0, 0
        while pos < total:
            size = sizes[k % len(sizes)]
            ctl(4006, vbr[k % len(vbr)])
            buf = ctypes.create_string_buffer(16000)
            r = op.opus_multistream_encode_float(
                enc, np.ascontiguousarray(pcm[pos:pos + size]).ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)), size, buf, 16000)
            assert r > 0, (name, r)
            packets.append(buf.raw[:r])
            pos += size
            k += 1
    finally:
        op.opus_multistream_encoder_destroy(enc)
    return packets, layout, lookahead.value


def opus_ms_head(channels: int, family: int, pre_skip: int, gain: int, layout) -> bytes:
    n_streams, coupled, table = layout
    return (b"OpusHead" + bytes([1, channels]) + struct.pack("<HIhB", pre_skip, 48000, gain, family)
            + bytes([n_streams, coupled]) + bytes(table))


def jax_ogg_opus_f32(data: bytes) -> tuple:
    """(float32 PCM, channels) of the JAX package's ``OggOpusDecoder`` over
    a whole Ogg Opus stream, flush included (libavcodec for a multistream
    head)."""
    from soundkit_tpu.codecs.opus import OggOpusDecoder

    dec = OggOpusDecoder()
    pcm = np.concatenate([dec.decode_f32(data), dec.flush()]).astype(np.float32)
    return pcm, dec.channels


def _ms_stream_codes(packets, n_streams: int) -> list:
    """The TOC codes (0-3) each stream's packets use, and whether a code-3
    packet of a stream is padded."""
    from soundkit_tpu_torch.codecs.opus_multistream import split_multistream_packet

    seen = [set() for _ in range(n_streams)]
    for p in packets:
        for s, part in enumerate(split_multistream_packet(p, n_streams)):
            code = part[0] & 3
            seen[s].add(code)
            if code == 3 and part[1] & 0x40:
                seen[s].add("padded")
    return [sorted(x, key=str) for x in seen]


def generate_opus_ms_fixtures(directory: Path = opus_ms_fixtures.FIXTURE_DIR) -> None:
    """Encode every clip of ``opus_ms_fixtures.CLIPS`` with libopus
    (:func:`libopus_ms_packets`), mux it in Ogg (one packet a page), decode
    it with the JAX package (libavcodec) and write the streams, the index
    and ``reference_pcm.npz``: the smoke clip's whole decode, and the first
    ``opus_ms_fixtures.REFERENCE_FRAMES`` frames of every other clip's."""
    directory.mkdir(parents=True, exist_ok=True)
    index, ref = {}, {}
    for name in opus_ms_fixtures.CLIPS:
        ch, family, _l, app, bit_rate, seconds, sizes, vbr, pre, gain, modes = OPUS_MS_CLIPS[name]
        packets, layout, lookahead = libopus_ms_packets(name)
        pre_skip = lookahead if pre is None else pre
        head = opus_ms_head(ch, family, pre_skip, gain, layout)
        data = opus_ms_fixtures.ogg_stream(head, packets)
        pcm, channels = jax_ogg_opus_f32(data)
        assert channels == ch and pcm.size % ch == 0, name
        codes = _ms_stream_codes(packets, layout[0])
        (directory / f"{name}.opus").write_bytes(data)
        index[name] = dict(
            file=f"{name}.opus", sha256=opus_ms_fixtures.sha256(data), channels=ch, family=family,
            streams=layout[0], coupled=layout[1], table=list(layout[2]), pre_skip=pre_skip,
            output_gain=gain, application={2048: "voip", 2049: "audio"}[app], bit_rate=bit_rate,
            frame_sizes=list(sizes), modes=[list(m) for m in modes] if modes else None,
            packets=[len(p) for p in packets], stream_codes=codes,
            frames=pcm.size // ch, pcm_sha256=opus_ms_fixtures.sha256(pcm.tobytes()))
        keep = None if name == opus_ms_fixtures.SMOKE else opus_ms_fixtures.REFERENCE_FRAMES * ch
        ref[name] = pcm[:keep]
    np.savez_compressed(directory / "reference_pcm.npz", **ref)
    (directory / "index.json").write_text(json.dumps(index, indent=1) + "\n")


#: family-1 output channel k carries Vorbis-order input channel ORDER[ch][k]
#: (measured on the JAX package's libavcodec decode of tones a channel)
LIBAVCODEC_ORDER = {1: [0], 2: [0, 1], 3: [0, 2, 1], 4: [0, 1, 2, 3], 5: [0, 2, 1, 3, 4],
                    6: [0, 2, 1, 5, 3, 4], 7: [0, 2, 1, 6, 5, 3, 4], 8: [0, 2, 1, 7, 5, 6, 3, 4]}


def opus_ms_sources(head: bytes) -> list:
    """(stream, channel) a multistream head's output channel takes, in
    libavcodec's order, (-1, 0) for silence."""
    ch, family, coupled = head[9], head[18], head[20]
    table = head[21:21 + ch]
    order = LIBAVCODEC_ORDER[ch] if family == 1 else list(range(ch))
    out = []
    for k in range(ch):
        idx = table[order[k]]
        out.append((-1, 0) if idx == 255 else (idx // 2, idx % 2) if idx < 2 * coupled
                   else (idx - coupled, 0))
    return out


def opus_ms_stream_kinds(head: bytes, packets) -> list:
    """'celt', 'silk' or 'hybrid' (any other mix) of each output channel,
    by the TOCs of its stream's packets; None for a silent channel."""
    from soundkit_tpu_torch.codecs.opus_core import TOC_ATTRS
    from soundkit_tpu_torch.codecs.opus_multistream import split_multistream_packet

    modes = [set() for _ in range(head[19])]
    for p in packets:
        for s, part in enumerate(split_multistream_packet(p, head[19])):
            modes[s].add(TOC_ATTRS[part[0]][0])
    kinds = [m.pop() if len(m) == 1 and m != {"hybrid"} else "hybrid" for m in map(set, modes)]
    return [None if s < 0 else kinds[s] for s, _c in opus_ms_sources(head)]


def libopus_ms_reference(head: bytes, packets) -> np.ndarray:
    """libopus's multistream decode of ``packets`` in libavcodec's channel
    order, pre-skip taken off and the output gain applied in float32, as
    the decoders under test apply them: [n, channels] float32."""
    ch, family = head[9], head[18]
    pre_skip, gain = struct.unpack_from("<Hxxxxh", head, 10)
    pcm = libopus_ms_decode(head, packets)
    if family == 1:
        pcm = pcm[:, LIBAVCODEC_ORDER[ch]]
    if gain:
        pcm = pcm * np.float32(10.0 ** (gain / (20.0 * 256.0)))
    return np.ascontiguousarray(pcm[pre_skip:], np.float32)


def opus_ms_readings() -> Dict[str, list]:
    """Per clip of ``tests/data/torch_port/opus_ms``, per output channel:
    (kind, dB against the JAX package's libavcodec decode, dB against
    libopus), the port's ``OggOpusDecoder`` on the CPU, whole stream and
    flush. Not a test: it gives the readings the floors of
    ``tests/test_torch_opus_multistream.py`` are set from. Run it as
    ``JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
    import torch_port_helpers as h; print(h.opus_ms_readings())"`` from the
    repository's root."""
    from soundkit_tpu_torch.codecs.opus import OggOpusDecoder

    out = {}
    for name in opus_ms_fixtures.CLIPS:
        data = opus_ms_fixtures.clip_bytes(name)
        head, packets = opus_ms_fixtures.head_and_packets(name)
        dec = OggOpusDecoder()
        got = np.concatenate([dec.decode_f32(data), dec.flush()]).reshape(-1, head[9])
        want = jax_ogg_opus_f32(data)[0].reshape(-1, head[9])
        lo = libopus_ms_reference(head, packets)[:len(got)]
        out[name] = [(kind, round(snr_db(got[:, k], want[:, k]), 2),
                      round(snr_db(got[:len(lo), k], lo[:, k]), 2))
                     for k, kind in enumerate(opus_ms_stream_kinds(head, packets)) if kind]
    return out


# ---------------------------------------------------------------------------
# multichannel AAC-LC fixtures (channel configurations 3-7)
# ---------------------------------------------------------------------------

AAC_MC_TONES = (330, 550, 770, 990, 1210, 1430, 1650, 1870)
AAC_MC_LFE_TONE = 60
#: the encoder's LFE input channel by channel count (libavcodec's default
#: layouts 2.1, 5.1, 6.1 and 7.1)
AAC_MC_LFE_INPUT = {3: 2, 6: 3, 7: 3, 8: 3}
AAC_MC_BIT_RATE = 128000  # a channel


def aac_mc_pcm(channels: int, seconds: float = 1.0) -> np.ndarray:
    """Interleaved int16 input of ``channels`` channels: a tone a channel
    (:data:`AAC_MC_TONES`, the LFE :data:`AAC_MC_LFE_TONE`) under seeded
    noise bursts of its own in the first two fifths of the clip."""
    rate = aac_mc_fixtures.RATE
    n = int(rate * seconds)
    t = np.arange(n) / rate
    rng = np.random.default_rng(4000 + channels)
    x = np.zeros((channels, n))
    for c in range(channels):
        lfe = AAC_MC_LFE_INPUT.get(channels) == c
        x[c] = 0.3 * np.sin(2 * np.pi * (AAC_MC_LFE_TONE if lfe else AAC_MC_TONES[c]) * t)
        if lfe:
            continue
        for _ in range(2):
            at = int(rng.integers(0, 3 * n // 10))
            x[c, at:at + rate // 10] += 0.15 * rng.standard_normal(rate // 10)
    return (np.clip(x, -1, 1).T.reshape(-1) * 32767).astype(np.int16)


def jax_owned_aac_planar(aus: List[bytes], sr_index: int = SR_INDEX_48K) -> np.ndarray:
    """[channels in bitstream order, samples] float64 of the JAX package's
    own ``AacLcDecoder`` + ``AacLcSynth`` on ``aus``."""
    from soundkit_tpu.codecs.aac_lc import AacLcDecoder
    from soundkit_tpu.ops.aac_dsp import AacLcSynth

    dec, synth = AacLcDecoder(sr_index), AacLcSynth(sr_index)
    return np.concatenate([synth.process_frame(dec.decode_au(au)) for au in aus], axis=1)


def jax_libavcodec_aac(data: bytes = None, config: bytes = None, aus=None) -> np.ndarray:
    """Interleaved float32 of the JAX package's libavcodec AAC decode: of
    ADTS ``data`` (``codecs.aac.AacDecoder``, which sends every stream
    beyond stereo to libavcodec), else of raw ``aus`` under ``config``
    (``AacRawDecoder``, libavcodec for every stream)."""
    from soundkit_tpu.codecs.aac import AacDecoder, AacRawDecoder

    if data is not None:
        dec = AacDecoder()
        return np.concatenate([dec.decode_f32(data), dec.flush_f32()]).astype(np.float32)
    dec = AacRawDecoder(config)
    return np.concatenate([dec.decode_access_unit_f32(au) for au in aus]
                          + [dec.flush_f32()]).astype(np.float32)


def measured_order(owned: np.ndarray, ref: np.ndarray) -> List[int]:
    """For each channel of ``ref`` [C, n], the channel of ``owned`` [C, n]
    that correlates best with it."""
    a = owned / np.maximum(np.linalg.norm(owned, axis=1, keepdims=True), 1e-30)
    b = ref / np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-30)
    return [int(np.argmax(np.abs(a @ b[i]))) for i in range(b.shape[0])]


def aac_mc_readings(owned: np.ndarray, ref: np.ndarray, aus: List[bytes], config: int) -> dict:
    """The PNS-aware figures of ``owned`` against ``ref`` (both [C, n]
    float64 in libavcodec's order): the PNS-free SNR and the PNS band
    energies (``aac_mc_fixtures.pns_free_snr`` / ``pns_band_energies``)."""
    frames = aac_mc_fixtures.frame_channels(aus, config)
    pns = aac_mc_fixtures.pns_flags(frames)
    return dict(pns_free=aac_mc_fixtures.pns_free_snr(owned, ref, pns),
                pns_channel_frames=int(pns.sum()),
                pns_energy=aac_mc_fixtures.pns_energy_summary(
                    aac_mc_fixtures.pns_band_energies(owned, ref, frames)))


def generate_aac_mc_fixtures(directory: Path = aac_mc_fixtures.FIXTURE_DIR) -> None:
    """Encode :func:`aac_mc_pcm` at 3-8 channels with the JAX package's
    ``AacEncoder``, splice ``cfg3`` and ``cfg7`` (``aac_mc_fixtures``),
    decode every clip with the JAX package's libavcodec and its own
    decoder, check libavcodec's channel order against
    ``codecs/aac_layout.LIBAVCODEC_ORDER``, and write the clips, the
    refused streams, the index and ``reference_pcm.npz``."""
    from soundkit_tpu.codecs.avdec import f32_to_i16
    from soundkit_tpu.codecs.encoders import AacEncoder
    from soundkit_tpu_torch.codecs.aac_layout import CHANNELS, LIBAVCODEC_ORDER
    from soundkit_tpu_torch.codecs.aac_lc import AdtsStream

    amf = aac_mc_fixtures
    directory.mkdir(parents=True, exist_ok=True)
    streams = {}
    for ch in (3, 4, 5, 6, 7, 8):
        enc = AacEncoder(amf.RATE, ch, AAC_MC_BIT_RATE * ch)
        streams[ch] = enc.encode_i16(aac_mc_pcm(ch)) + enc.flush()
    aus = {ch: AdtsStream().push(data) for ch, data in streams.items()}
    clips = {"cfg3": (amf.adts([amf.splice(au, [0, 1]) for au in aus[4]], 3),
                      "the 4.0 stream's SCE and CPE"),
             "cfg4": (streams[4], "the encoder's 4.0 stream"),
             "cfg5": (streams[5], "the encoder's 5.0 stream"),
             "cfg6": (streams[6], "the encoder's 5.1 stream"),
             "cfg7": (amf.adts(aus[8][1:], 7), "the 7.1 stream without its PCE unit"),
             "enc_21": (streams[3], "the encoder's 2.1 stream"),
             "enc_61": (streams[7], "the encoder's 6.1 stream"),
             "enc_71_pce": (streams[8], "the encoder's 7.1 stream")}
    index, ref = {}, {}
    for name, (data, source) in clips.items():
        (directory / f"{name}.aac").write_bytes(data)
        st = AdtsStream()
        units = st.push(data)
        pcm = jax_libavcodec_aac(data)
        e = dict(file=f"{name}.aac", sha256=amf.sha256(data), config=st.channel_config,
                 source=source, frames=len(units),
                 elements=[k for k, _, _ in amf.element_spans(units[1])],
                 libavcodec_samples=int(pcm.size),
                 libavcodec_sha256=amf.sha256(pcm.tobytes()))
        index[name] = e
        if name in amf.REFUSED:
            assert pcm.size == 0, name
            continue
        config = st.channel_config
        assert config == amf.CLIPS[name] and pcm.size == len(units) * 1024 * CHANNELS[config], name
        av = pcm.reshape(-1, CHANNELS[config]).T.astype(np.float64)
        planar = jax_owned_aac_planar(units)
        order = measured_order(planar, av)
        assert order == list(LIBAVCODEC_ORDER[config]), (name, order)
        owned = planar[order]
        ref[f"pcm_{name}"] = f32_to_i16(owned.T.reshape(-1).astype(np.float32))
        ref[f"pns_{name}"] = amf.pns_flags(amf.frame_channels(units, config))
        if name == amf.SMOKE:
            ref[f"libavcodec_{name}"] = pcm
        e.update(order=order, **aac_mc_readings(owned, av, units, config))
    (directory / "index.json").write_text(json.dumps(index, indent=1) + "\n")
    config, units = amf.units(amf.SMOKE, directory)
    planar = jax_owned_aac_planar(units)[list(LIBAVCODEC_ORDER[6])]
    for name in amf.CONTAINERS:
        data = amf.build(name)
        pcm = jax_libavcodec_aac(config=config, aus=units)
        av = pcm.reshape(-1, 6).T.astype(np.float64)
        index[name] = dict(sha256_bytes=amf.sha256(data), clip=amf.SMOKE,
                           libavcodec_samples=int(pcm.size),
                           libavcodec_sha256=amf.sha256(pcm.tobytes()),
                           **aac_mc_readings(planar, av, units, 6))
    np.savez_compressed(directory / "reference_pcm.npz", **ref)
    (directory / "index.json").write_text(json.dumps(index, indent=1) + "\n")


if __name__ == "__main__":
    {"aac": generate_aac_fixtures, "telephony": generate_telephony_fixtures,
     "flac": generate_flac_fixtures, "mp3": generate_mp3_fixtures,
     "opus": generate_opus_fixtures, "silk_resampler": generate_silk_resampler_table,
     "vorbis": generate_vorbis_fixtures,
     "host_codecs": generate_host_codec_fixtures, "celp": generate_celp_fixtures,
     "containers": generate_container_index,
     "mpa": generate_mpa_fixtures, "opus_ms": generate_opus_ms_fixtures,
     "aac_mc": generate_aac_mc_fixtures}[sys.argv[1]]()


# ---------------------------------------------------------------------------
# the AAC-LC gap to libavcodec (ROADMAP §3)
# ---------------------------------------------------------------------------

def port_owned_aac_planar(aus: List[bytes], sr_index: int = SR_INDEX_48K) -> np.ndarray:
    """[channels in bitstream order, samples] float64 of the port's copies
    of ``AacLcDecoder`` + ``AacLcSynth`` on ``aus`` (the synthesis before
    the float32 cast of ``codecs/aac``'s decoders)."""
    from soundkit_tpu_torch.codecs.aac_lc import AacLcDecoder
    from soundkit_tpu_torch.ops.aac_dsp import AacLcSynth

    dec, synth = AacLcDecoder(sr_index), AacLcSynth(sr_index)
    return np.concatenate([synth.process_frame(dec.decode_au(au)) for au in aus], axis=1)


def aac_batched_libavcodec_snr(path: str = "batched") -> Dict[str, dict]:
    """The PNS-aware comparison (``aac_mc_readings``) of the port's AAC-LC
    decode against the JAX package's libavcodec decode of the same
    stream, both aligned at sample 0: for each in-repo stereo clip, and
    for the ``m4a_aac`` and ``latm_8`` container cases (their access units
    under their config, libavcodec's ``AacRawDecoder``). A waveform SNR
    over whole clips cannot tell a decoder fault from perceptual noise
    substitution, whose noise two decoders draw differently; this one
    reads the PNS-free channel-frames' SNR and each PNS band's energy.
    ``path`` "batched" decodes the clips with ``BatchedAacLcDecoder`` at
    six lanes on the CPU (the v4 wire in float32, ~70 s here) and the
    container cases with the port's float64 synthesis; "host" decodes
    everything with the port's ``AacLcDecoder`` + ``AacLcSynth`` in
    float64 (~10 s). Not a test: ``tests/test_torch_aac_multichannel.py``
    holds the host path's figures. Run it as ``JAX_PLATFORMS=cpu python -c
    "import sys; sys.path.insert(0, 'tests'); import torch_port_helpers as
    h; print(h.aac_batched_libavcodec_snr())"`` from the repository's root."""
    from soundkit_tpu.codecs.avdec import AvDecoder

    clips = aac_fixtures.load_clips()
    aus = aac_fixtures.clip_aus(clips)
    if path == "batched":
        from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder

        model = BatchedAacLcDecoder(len(clips), 2, device="cpu")
        for lane, frames in enumerate(clips):
            model.push(lane, b"".join(frames))
        pcm = model.decode_batches(max(len(f) for f in clips))
        got = [pcm[:len(f), lane].transpose(1, 0, 2).reshape(2, -1).astype(np.float64)
               for lane, f in enumerate(clips)]
    else:
        got = [port_owned_aac_planar(u) for u in aus]
    out = {}
    for name, frames, units, mine in zip(aac_fixtures.CLIPS, clips, aus, got):
        av = AvDecoder("aac", use_parser=True)
        ref = np.concatenate([av.push(b"".join(frames)), av.flush()]).reshape(-1, 2).T
        out[name] = aac_mc_readings(mine, ref.astype(np.float64), units, 2)
    for case in ("m4a_aac", "latm_8"):
        config, units = container_fixtures.units(case)
        ref = jax_libavcodec_aac(config=config, aus=units).reshape(-1, 2).T
        out[case] = aac_mc_readings(port_owned_aac_planar(units), ref.astype(np.float64), units, 2)
    return out


# ---------------------------------------------------------------------------
# MPEG audio Layer I / II against libavcodec
# ---------------------------------------------------------------------------

def mpa_libavcodec_snr() -> Dict[str, float]:
    """Float32 SNR in dB of the port's ``Mp3Decoder(device="cpu")`` against
    the JAX package's (libavcodec) on each ``tests/data/torch_port/mpa``
    clip, whole stream then flush. Not a test (the test holds each at 100
    dB): it records the margin. Run it as ``JAX_PLATFORMS=cpu python -c
    "import sys; sys.path.insert(0, 'tests'); import torch_port_helpers as
    h; print(h.mpa_libavcodec_snr())"`` from the repository's root."""
    from soundkit_tpu_torch.codecs.mp3 import Mp3Decoder

    out = {}
    for name in sorted(mpa_fixtures.load_index()):
        data = mpa_fixtures.clip_bytes(name)
        dec = Mp3Decoder(device="cpu")
        got = np.concatenate([dec.decode_f32(data), dec.flush_f32()])
        out[name] = round(snr_db(got, jax_mpa_f32(data)[0]), 2)
    return out
