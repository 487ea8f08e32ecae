"""In-repo AAC-LC fixtures for the port's tests and ``chip_smoke.py``.

Six synthetic 48 kHz stereo clips, about 4 s each, encoded at 96 kbps
with the JAX package's ``AacEncoder`` (libavcodec) and committed as
ADTS files under ``tests/data/torch_port/``. The content mix covers
the decode paths of the v4 wire: PNS noise bands, M/S, intensity,
EIGHT_SHORT transients and TNS filters. Every AU is v4-clean (a
single-AU v4 parse reports no overflow).

Regenerate (needs the JAX package's native library with FFmpeg)::

    python -m soundkit_tpu_torch.tools.aac_fixtures

Reading the fixtures needs neither JAX nor FFmpeg.
"""
from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from soundkit_tpu.codecs.aac_lc import AdtsStream

RATE = 48000
SECONDS = 4.0
BIT_RATE = 96000
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port"
CLIPS = ("noise_pad", "castanets", "chords", "speech_like", "drums", "sweep_pan")


# ---------------------------------------------------------------------------
# synthesis (seeded numpy; stereo float in [-1, 1])
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# fixture access
# ---------------------------------------------------------------------------

def split_adts(data: bytes) -> List[bytes]:
    """Whole ADTS frames (headers kept) of a synced ADTS stream."""
    frames = []
    off = 0
    while off + 7 <= len(data):
        if data[off] != 0xFF or (data[off + 1] & 0xF6) != 0xF0:
            raise ValueError(f"ADTS sync lost at byte {off}")
        n = ((data[off + 3] & 3) << 11) | (data[off + 4] << 3) | (data[off + 5] >> 5)
        frames.append(data[off : off + n])
        off += n
    return frames


def load_clips(directory: Path = FIXTURE_DIR) -> List[List[bytes]]:
    """ADTS frames of every committed clip, in ``CLIPS`` order."""
    return [split_adts((directory / f"{name}.aac").read_bytes()) for name in CLIPS]


def clip_aus(clips: List[List[bytes]]) -> List[List[bytes]]:
    """Raw AUs (ADTS headers stripped) of every clip's frames."""
    return [AdtsStream().push(b"".join(frames)) for frames in clips]


def lane_frame(clips: List[List[bytes]], lane: int, t: int) -> bytes:
    """Frame (or AU) ``t`` of smoke lane ``lane``: the lane plays clip
    ``lane mod len(clips)`` from frame ``lane // len(clips)``, one frame
    per batch, wrapping at the clip's end. Each (clip, offset) pair is
    distinct while lanes / clips stays below the shortest clip's length."""
    frames = clips[lane % len(clips)]
    return frames[(lane // len(clips) + t) % len(frames)]


def lane_streams(clips: List[List[bytes]], num_lanes: int, n_frames: int) -> List[bytes]:
    """ADTS bytes of ``n_frames`` frames for each of ``num_lanes`` smoke lanes."""
    return [b"".join(lane_frame(clips, i, t) for t in range(n_frames)) for i in range(num_lanes)]


def batch_aus(clip_aus: List[List[bytes]], num_lanes: int, t: int) -> List[bytes]:
    """Raw AUs of batch ``t`` across ``num_lanes`` smoke lanes."""
    return [lane_frame(clip_aus, i, t) for i in range(num_lanes)]


def generate(directory: Path = FIXTURE_DIR) -> None:
    """Synthesize, encode and write every clip (needs libavcodec)."""
    from soundkit_tpu.codecs.encoders import AacEncoder

    directory.mkdir(parents=True, exist_ok=True)
    n = int(RATE * SECONDS)
    for seed, name in enumerate(CLIPS):
        rng = np.random.default_rng(1000 + seed)
        x = _SYNTH[name](n, rng)
        x = x / max(np.max(np.abs(x)), 1e-9) * 0.85
        pcm = (x.T.reshape(-1) * 32767).astype(np.int16)
        enc = AacEncoder(RATE, 2, BIT_RATE)
        (directory / f"{name}.aac").write_bytes(enc.encode_i16(pcm) + enc.flush())


if __name__ == "__main__":
    generate()
