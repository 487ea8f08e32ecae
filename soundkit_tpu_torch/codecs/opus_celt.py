"""The part of the JAX package's ``codecs/opus_celt.py`` that the
port's CELT synthesis needs, copied verbatim: the overlap, the
de-emphasis pole and the low-overlap IMDCT basis, over the port's copy
of the RFC 6716 tables (``codecs/opus_tables.py``).

The range decode, allocation and PVQ stages run in the port's build of
``native_src/src/celt_parse.cpp`` (``codecs/celt_native.py``); the
Python ``CeltDecoder`` is not ported.
"""
from __future__ import annotations

import numpy as np

from soundkit_tpu_torch.codecs.opus_tables import tables

OVERLAP = 120
# de-emphasis pole: the float build uses the Q15 constant 27853/32768,
# not 0.85 exactly
CELT_EMPH_COEFF = 27853.0 / 32768.0


_IMDCT_CACHE = {}


def _imdct_matrix(NB: int) -> np.ndarray:
    """[NB, NB+OVERLAP] low-overlap IMDCT basis: bin k -> windowed time
    response at hop NB (window rises over OVERLAP, flat middle)."""
    if NB in _IMDCT_CACHE:
        return _IMDCT_CACHE[NB]
    t = tables()
    w = t["celt_window"].astype(np.float64)
    L = 2 * NB
    n = np.arange(L, dtype=np.float64)
    k = np.arange(NB, dtype=np.float64)
    # oddly-stacked IMDCT, n0 = (L/2 + 1)/... standard MDCT phase
    # unnormalized backward transform: the energy convention carries
    # the scale, and the final /32768 maps celt_sig to float PCM
    basis = np.cos(
        2.0 * np.pi / L
        * (n[None, :] + 0.5 + L / 4.0) * (k[:, None] + 0.5)
    )
    # low-overlap window: support is the middle NB+OVERLAP samples
    win = np.zeros(L)
    pad = (NB - OVERLAP) // 2
    win[pad : pad + OVERLAP] = w
    win[pad + OVERLAP : pad + NB] = 1.0
    win[pad + NB : pad + NB + OVERLAP] = w[::-1]
    mat = (basis * win[None, :])[:, pad : pad + NB + OVERLAP]
    _IMDCT_CACHE[NB] = mat
    return mat
