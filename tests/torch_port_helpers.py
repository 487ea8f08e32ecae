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
"""
from __future__ import annotations

import functools
import json
import struct
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

from soundkit_tpu_torch.models.telephony_batch import CODECS
from soundkit_tpu_torch.tools import (aac_fixtures, flac_fixtures, mp3_fixtures, opus_fixtures,
                                      telephony_fixtures, vorbis_fixtures)

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


def libopus_voice_packets(pcm: np.ndarray, bit_rate: int, max_bandwidth: int, mode: int,
                          toggle_channels: bool = False):
    """(packets, lookahead) of ``pcm`` float32 [n, channels] at 48 kHz by
    the system's libopus (``libopus.so.0``, as ``tests/test_fleet.py``
    opens it) in its VoIP application: voice signal, ``bit_rate``,
    ``max_bandwidth`` (OPUS_BANDWIDTH_*) as the maximum and the set
    bandwidth, and ``mode`` forced (1000 SILK, 1001 hybrid, 1002 CELT; a
    list gives a packet's mode by its index). ``toggle_channels`` forces
    mono coding every other half second."""
    import ctypes

    op = ctypes.CDLL("libopus.so.0")
    op.opus_encoder_create.restype = ctypes.c_void_p
    op.opus_encoder_create.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    op.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
    op.opus_encode_float.restype = ctypes.c_int
    op.opus_encode_float.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_int]
    op.opus_encoder_ctl.restype = ctypes.c_int
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
    frames, an OpusHead of mapping family 1 or of three channels, a
    switch from CELT to SILK in mid-stream, and a hybrid stream that
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


if __name__ == "__main__":
    {"aac": generate_aac_fixtures, "telephony": generate_telephony_fixtures,
     "flac": generate_flac_fixtures, "mp3": generate_mp3_fixtures,
     "opus": generate_opus_fixtures, "silk_resampler": generate_silk_resampler_table,
     "vorbis": generate_vorbis_fixtures}[sys.argv[1]]()
