"""MP3 Layer III synthesis constants (copied from
``soundkit_tpu/ops/mp3_dsp.py``): the alias-reduction coefficients, the
IMDCT matrices and windows, and the polyphase matrixing and D window,
in float64 numpy. Only the builders the batched device path needs; the
numpy reference decoder there (``ChannelSynth``, ``Mp3Synth``) is not
ported.

``enwindow`` for the D window comes from the port's copy of the JAX
package's table file, ``data/mp3_tables.npz``.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

TABLES_PATH = Path(__file__).resolve().parent.parent / "data" / "mp3_tables.npz"


@functools.lru_cache(maxsize=1)
def _tables():
    return {"enwindow": np.load(TABLES_PATH)["enwindow"].astype(np.int64)}


# alias-reduction coefficients (ISO 11172-3 Table B.9 ci values)
_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
CS = 1.0 / np.sqrt(1.0 + _CI * _CI)
CA = _CI * CS


@functools.lru_cache(maxsize=4)
def imdct_matrix(n_out: int) -> np.ndarray:
    """[n_out, n_out//2] IMDCT: x[n] = sum_k X[k] cos(pi/(2N)(2n+1+N/2)(2k+1))."""
    N = n_out
    half = N // 2
    n = np.arange(N)[:, None]
    k = np.arange(half)[None, :]
    return np.cos(np.pi / (2 * N) * (2 * n + 1 + half) * (2 * k + 1))


@functools.lru_cache(maxsize=1)
def imdct_windows() -> np.ndarray:
    """[4, 36] windows for block types 0..3 (type 2 = short, unused here)."""
    w = np.zeros((4, 36))
    n = np.arange(36)
    w[0] = np.sin(np.pi / 36 * (n + 0.5))
    w[1, :18] = np.sin(np.pi / 36 * (n[:18] + 0.5))
    w[1, 18:24] = 1.0
    w[1, 24:30] = np.sin(np.pi / 12 * (np.arange(24, 30) - 18 + 0.5))
    w[3, 6:12] = np.sin(np.pi / 12 * (np.arange(6, 12) - 6 + 0.5))
    w[3, 12:18] = 1.0
    w[3, 18:] = np.sin(np.pi / 36 * (n[18:] + 0.5))
    return w


@functools.lru_cache(maxsize=1)
def short_window() -> np.ndarray:
    return np.sin(np.pi / 12 * (np.arange(12) + 0.5))


@functools.lru_cache(maxsize=1)
def synth_matrix() -> np.ndarray:
    """[64, 32] polyphase matrixing: N[i][k] = cos((16+i)(2k+1) pi/64)."""
    i = np.arange(64)[:, None]
    k = np.arange(32)[None, :]
    return np.cos((16 + i) * (2 * k + 1) * np.pi / 64)


@functools.lru_cache(maxsize=1)
def synth_window() -> np.ndarray:
    """[512] ISO Table B.3 D window from the extracted enwindow
    half-table (enwindow = D * 65536).

    Mirror structure (validated to 126 dB vs oracle): D[i] = E[i] for
    i <= 256; D[512-i] = -E[i], EXCEPT +E[i] at i in {64, 128, 192}
    (the positions feeding output sample 0 of each 32-round).
    """
    e = _tables()["enwindow"].astype(np.float64) / 65536.0
    d = np.zeros(512)
    d[:257] = e
    for i in range(1, 256):
        d[512 - i] = (e[i] if (i & 63) == 0 else -e[i])
    return d
