"""The one piece of ``soundkit_tpu/codecs/avdec.py`` the port needs:
:func:`f32_to_i16`, the float-to-int16 conversion of the streaming
adapters (MP3, AAC, Opus, Vorbis). The libavcodec decoder there (``AvDecoder``) is not ported:
the port builds no FFmpeg, and the shapes the JAX package hands to it
raise in the port's codecs instead."""
from __future__ import annotations

import numpy as np


def f32_to_i16(x: np.ndarray) -> np.ndarray:
    """round(x * 32768) with clamp.

    The shim normalizes integer-native decoder output (ALAC, GSM, ...)
    as s/32768; multiplying by 32768 and rounding recovers the exact
    integers, keeping lossless paths bit-exact.  (The pipeline's
    options stage uses the reference's *32767-truncate separately.)
    """
    scaled = np.rint(np.asarray(x, np.float64) * 32768.0)
    return np.clip(scaled, -32768, 32767).astype(np.int16)
