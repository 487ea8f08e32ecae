"""In-repo telephony fixtures for the port's tests and ``chip_smoke.py``.

Six seeded synthetic clips of 2 s (speech-like formant bursts, a sweep,
tones with silence, noise, full-scale clipping, near-silence), made at
8 kHz for G.711 / G.726 and at 16 kHz for G.722, encoded for each of
the seven codecs with the JAX package's ``BatchedTelephonyEncoder`` and
committed as raw wire bytes under
``tests/data/torch_port/telephony/<clip>.<codec>`` (G.726 packed
MSB-first, as ffmpeg's ``g726``).

This module makes the PCM clips (:func:`pcm_clips`), reads the wire
files and cuts both into lanes. The wire files are encoded on the test
side (``tests/torch_port_helpers.py``; needs JAX, on its CPU backend),
from the repository's root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py telephony
"""
from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

CLIPS = ("formants", "sweep", "tones", "noise", "clipping", "near_silence")
SECONDS = 2.0
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port" / "telephony"
# every lane cut is a multiple of this many samples: a whole G.726
# packing group at every rate (4, 8, 2 and 8 samples) and a G.722 pair
UNIT = 8


def sample_rate(codec: str) -> int:
    return 16000 if codec == "g722" else 8000


def samples_per_byte(codec: str) -> float:
    """Samples that one wire byte carries."""
    if codec == "g722":
        return 2.0
    if codec.startswith("g726"):
        return 8 / (int(codec.split("_")[1]) // 8)
    return 1.0


# ---------------------------------------------------------------------------
# synthesis (seeded numpy; float in [-1, 1])
# ---------------------------------------------------------------------------

def _resonator(x, fc, bw, rate):
    """x through a two-pole resonator (its impulse response, truncated)."""
    r = np.exp(-np.pi * bw / rate)
    w = 2 * np.pi * fc / rate
    n = np.arange(int(rate * 0.05))
    h = r**n * np.sin(w * (n + 1)) / np.sin(w)
    return np.convolve(x, h)[: len(x)]


def _formants(n, rate, rng):
    t = np.arange(n) / rate
    f0 = 110 + 50 * np.sin(2 * np.pi * 0.8 * t)
    pulses = (np.diff(np.floor(np.cumsum(f0 / rate)), prepend=0) > 0).astype(float)
    x = sum(_resonator(pulses, fc, bw, rate) * g
            for fc, bw, g in ((650, 80, 1.0), (1100, 100, 0.6), (2500, 150, 0.3)))
    syl = np.convolve((np.sin(2 * np.pi * 3.3 * t) > -0.1).astype(float),
                      np.ones(rate // 50) / (rate // 50), mode="same")
    fric = rng.standard_normal(n) * 0.04 * (1 - syl)
    return x / np.max(np.abs(x)) * 0.8 * syl + fric


def _sweep(n, rate, rng):
    t = np.arange(n) / rate
    f = 60 * (0.45 * rate / 60) ** (t / SECONDS)
    return 0.7 * np.sin(2 * np.pi * np.cumsum(f) / rate)


def _tones(n, rate, rng):
    t = np.arange(n) / rate
    x = np.zeros(n)
    seg = n // 8
    for k in range(0, 8, 2):  # tone pairs in even slots, silence between
        lo, hi = rng.choice([697, 770, 852, 941]), rng.choice([1209, 1336, 1477])
        s = slice(k * seg, (k + 1) * seg)
        x[s] = 0.35 * (np.sin(2 * np.pi * lo * t[s]) + np.sin(2 * np.pi * hi * t[s]))
    return x


def _noise(n, rate, rng):
    white = rng.standard_normal(n)
    pinkish = np.convolve(white, np.ones(4) / 2, mode="same")
    return np.clip(0.25 * pinkish, -1, 1)


def _clipping(n, rate, rng):
    t = np.arange(n) / rate
    return np.clip(3.0 * np.sin(2 * np.pi * 180 * t) + 0.3 * rng.standard_normal(n), -1, 1)


def _near_silence(n, rate, rng):
    t = np.arange(n) / rate
    x = (rng.standard_normal(n) * 6.0 + 16.0 * np.sin(2 * np.pi * 300 * t)) / 32768
    x[n // 3: n // 2] = 0.0
    return x


_SYNTH = {"formants": _formants, "sweep": _sweep, "tones": _tones, "noise": _noise,
          "clipping": _clipping, "near_silence": _near_silence}


def pcm_clips(rate: int) -> List[np.ndarray]:
    """The six clips at ``rate`` as int16, in ``CLIPS`` order; full
    scale maps to [-32768, 32767]."""
    n = int(rate * SECONDS)
    out = []
    for seed, name in enumerate(CLIPS):
        x = _SYNTH[name](n, rate, np.random.default_rng(2000 + seed))
        out.append(np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16))
    return out


# ---------------------------------------------------------------------------
# fixture access
# ---------------------------------------------------------------------------

def load_clips(codec: str, directory: Path = FIXTURE_DIR) -> List[bytes]:
    """Wire bytes of every committed clip for ``codec``, in ``CLIPS`` order."""
    return [(directory / f"{name}.{codec}").read_bytes() for name in CLIPS]


def _lane_cut(i: int, n_units: int):
    """(offset, length) of lane ``i`` in units of its clip: lane i plays
    clip ``i mod 6`` from offset ``11 * (i // 6)`` units, wrapping; every
    fourth lane plays a shorter stream of 1/8 to 7/8 of the clip."""
    off = (11 * (i // len(CLIPS))) % n_units
    length = n_units if i % 4 != 3 else n_units * (1 + (i // 4) % 7) // 8
    return off, length


def _rotate(a, off: int, length: int):
    return np.concatenate([a[off:], a[:off]])[:length]


def lane_streams(codec: str, num_lanes: int, directory: Path = FIXTURE_DIR) -> List[bytes]:
    """The wire bytes of ``num_lanes`` distinct decode lanes, cut in
    whole units of ``UNIT`` samples (whole G.726 packing groups)."""
    clips = [np.frombuffer(c, np.uint8) for c in load_clips(codec, directory)]
    unit = round(UNIT / samples_per_byte(codec))  # bytes per UNIT samples
    out = []
    for i in range(num_lanes):
        clip = clips[i % len(clips)]
        off, length = _lane_cut(i, len(clip) // unit)
        out.append(_rotate(clip, off * unit, length * unit).tobytes())
    return out


def lane_pcm(codec: str, num_lanes: int) -> List[np.ndarray]:
    """The int16 PCM of ``num_lanes`` distinct encode lanes at the
    codec's rate, cut as :func:`lane_streams` cuts the wire."""
    clips = pcm_clips(sample_rate(codec))
    out = []
    for i in range(num_lanes):
        clip = clips[i % len(clips)]
        off, length = _lane_cut(i, len(clip) // UNIT)
        out.append(_rotate(clip, off * UNIT, length * UNIT))
    return out
