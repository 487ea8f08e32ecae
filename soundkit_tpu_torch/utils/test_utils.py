"""Decode-result metrics and ASCII waveform rendering.

Behavioral equivalent of ``soundkit/src/test_utils.rs``:
``DecodeResult`` with RMS / duration / 120-bin waveform peaks
(:8-100), peak binning (:110-152), ASCII waveform charts used by the
decoder integration tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

WAVEFORM_WIDTH = 60
WAVEFORM_HEIGHT = 8


def compute_waveform_peaks(samples: np.ndarray, num_bins: int, max_value: float) -> np.ndarray:
    samples = np.asarray(samples)
    if len(samples) == 0 or num_bins == 0:
        return np.zeros(0, dtype=np.float32)
    bin_size = -(-len(samples) // num_bins)
    pad = bin_size * num_bins - len(samples)
    mat = np.abs(samples.astype(np.float64))
    mat = np.pad(mat, (0, pad))
    peaks = mat.reshape(-1, bin_size).max(axis=1) / max_value
    # trailing all-pad bins correspond to no chunks in the reference
    n_chunks = -(-len(samples) // bin_size)
    return peaks[:n_chunks].astype(np.float32)


@dataclass
class DecodeResult:
    bytes: int
    sample_count: int
    sample_rate: int
    channels: int
    rms: float
    waveform: np.ndarray

    @classmethod
    def new(cls, samples: np.ndarray, sample_rate: int, channels: int) -> "DecodeResult":
        samples = np.asarray(samples, dtype=np.int16)
        n = len(samples)
        norm = samples.astype(np.float64) / 32768.0
        rms = float(np.sqrt(np.mean(norm**2))) if n else 0.0
        return cls(
            bytes=n * 2,
            sample_count=n,
            sample_rate=sample_rate,
            channels=channels,
            rms=rms,
            waveform=compute_waveform_peaks(samples, WAVEFORM_WIDTH * 2, 32768.0),
        )

    @classmethod
    def from_i32_with_bits(
        cls, samples: np.ndarray, sample_rate: int, channels: int, bits_per_sample: int
    ) -> "DecodeResult":
        samples = np.asarray(samples, dtype=np.int32)
        n = len(samples)
        max_value = float(1 << (bits_per_sample - 1))
        norm = samples.astype(np.float64) / max_value
        rms = float(np.sqrt(np.mean(norm**2))) if n else 0.0
        return cls(
            bytes=n * 4,
            sample_count=n,
            sample_rate=sample_rate,
            channels=channels,
            rms=rms,
            waveform=compute_waveform_peaks(samples, WAVEFORM_WIDTH * 2, max_value),
        )

    @property
    def duration_secs(self) -> float:
        if self.sample_rate == 0 or self.channels == 0:
            return 0.0
        return self.sample_count / self.channels / self.sample_rate

    @property
    def rms_db(self) -> float:
        return 20.0 * np.log10(self.rms) if self.rms > 0 else -96.0


def render_waveform(waveform: np.ndarray, height: int = WAVEFORM_HEIGHT) -> str:
    """ASCII art: one column per pair of bins, '█' fill by peak level."""
    if len(waveform) == 0:
        return "(empty)"
    cols = waveform[: WAVEFORM_WIDTH * 2 : 2]
    lines = []
    for row in range(height, 0, -1):
        threshold = row / height
        lines.append(
            "".join("█" if c >= threshold * waveform.max() and waveform.max() > 0 else " " for c in cols)
        )
    lines.append("─" * len(cols))
    return "\n".join(lines)


def print_waveform_comparison(results: List[Tuple[str, DecodeResult]]) -> str:
    out = ["", "  Decoded Audio Waveforms", "  " + "═" * 70, ""]
    for name, r in results:
        out.append(
            f"  {name} ({r.duration_secs:.2f}s, {r.sample_rate} Hz, "
            f"{r.channels} ch, {r.rms_db:.1f} dB)"
        )
        out.append(render_waveform(r.waveform))
        out.append("")
    text = "\n".join(out)
    print(text)
    return text
