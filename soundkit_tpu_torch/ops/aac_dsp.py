"""AAC synthesis constants (copied from ``soundkit_tpu/ops/aac_dsp.py``):
the IMDCT matrix and the sine / Kaiser-Bessel-derived half windows, in
float64 numpy."""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def imdct_matrix(n_coefs: int) -> np.ndarray:
    """[N, n_coefs] IMDCT matrix, N = 2*n_coefs."""
    N = 2 * n_coefs
    n0 = (n_coefs + 1) / 2.0
    n = np.arange(N, dtype=np.float64)[:, None]
    k = np.arange(n_coefs, dtype=np.float64)[None, :]
    return (2.0 / N) * np.cos(2.0 * np.pi / N * (n + n0) * (k + 0.5))


@functools.lru_cache(maxsize=8)
def sine_window(n: int) -> np.ndarray:
    """Ascending half of the sine window (n values)."""
    return np.sin(np.pi / (2 * n) * (np.arange(n) + 0.5))


@functools.lru_cache(maxsize=8)
def kbd_window(n: int, alpha: float) -> np.ndarray:
    """Ascending half of the Kaiser-Bessel derived window (n values)."""
    kaiser = np.kaiser(n + 1, np.pi * alpha)
    cum = np.cumsum(kaiser)
    return np.sqrt(cum[:n] / cum[n])


def half_window(shape: int, n: int) -> np.ndarray:
    if shape:  # 1 = KBD
        return kbd_window(n, 4.0 if n == 1024 else 6.0)
    return sine_window(n)
