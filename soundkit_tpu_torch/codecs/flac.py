"""FLAC errors (counterpart of ``soundkit_tpu/codecs/flac.py``; the
streaming host decoder there comes with the pipeline)."""
from __future__ import annotations


class FlacError(ValueError):
    pass
