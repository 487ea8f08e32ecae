"""ASCII waveform rendering.

Behavioral analog of the reference's debug waveform charts
(soundkit-decoder/src/lib.rs:2729-2853): render per-window peak
amplitudes as a block-character chart (mirrored top/bottom halves,
8-level block glyphs), with a header line carrying duration and RMS dB.
Own implementation — numpy windowed peaks instead of a streaming
accumulator.
"""
from __future__ import annotations

from typing import List

import numpy as np

WAVEFORM_WIDTH = 64
WAVEFORM_HEIGHT = 8
_CHARS = " ▁▂▃▄▅▆▇█"


def waveform_peaks(pcm: np.ndarray, buckets: int = WAVEFORM_WIDTH) -> np.ndarray:
    """Per-bucket |peak| of a mono f32/f64/int signal, [buckets] f32."""
    x = np.asarray(pcm, dtype=np.float64).reshape(-1)
    if np.issubdtype(np.asarray(pcm).dtype, np.integer):
        x = x / 32768.0
    if len(x) == 0:
        return np.zeros(buckets, np.float32)
    edges = (np.arange(buckets + 1) * len(x)) // buckets
    out = np.zeros(buckets, np.float32)
    for i in range(buckets):
        seg = x[edges[i] : max(edges[i + 1], edges[i] + 1)]
        out[i] = float(np.max(np.abs(seg))) if len(seg) else 0.0
    return out


def render_waveform(peaks: np.ndarray, height: int = WAVEFORM_HEIGHT) -> List[str]:
    """Mirrored block chart, top half then bottom half (reference
    print_waveform's layout)."""
    p = np.asarray(peaks, np.float64)
    if len(p) == 0:
        return ["  (no audio data)"]
    mx = max(float(p.max()), 0.001)
    norm = p / mx
    half = max(height // 2, 1)
    lines = []
    for row in range(half - 1, -1, -1):
        cells = []
        for v in norm:
            # fill fraction of this row's cell: 0 empty .. 8 full block
            fill = int(np.clip((v * half - row) * (len(_CHARS) - 1), 0, len(_CHARS) - 1))
            cells.append(_CHARS[fill])
        lines.append("  " + "".join(cells))
    return lines + list(reversed(lines))


def waveform_chart(name: str, pcm: np.ndarray, sample_rate: int) -> str:
    """Full chart for one decoded result: header + mirrored waveform."""
    x = np.asarray(pcm, dtype=np.float64).reshape(-1)
    if np.issubdtype(np.asarray(pcm).dtype, np.integer):
        x = x / 32768.0
    dur = len(x) / sample_rate if sample_rate else 0.0
    rms = float(np.sqrt(np.mean(x**2))) if len(x) else 0.0
    db = 20.0 * np.log10(rms) if rms > 0 else -96.0
    lines = [f"  {name} ({dur:.2f}s, {db:.1f} dB)"]
    lines += render_waveform(waveform_peaks(x))
    return "\n".join(lines)
