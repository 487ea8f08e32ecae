"""Adapter factories of the autodetect pipeline (counterpart of
``soundkit_tpu/pipeline/adapters.py``).

``decode_pipeline._init_decoder`` calls these lazily. A codec the port
does not have yet raises ``UnsupportedFormat`` with a clear message
rather than failing detection.
"""
from __future__ import annotations

from soundkit_tpu_torch.pipeline.output_options import UnsupportedFormat


def make_mp3_adapter(device="cuda"):
    from soundkit_tpu_torch.codecs.mp3 import Mp3Adapter

    return Mp3Adapter(device)


def make_aac_adts_adapter():
    from soundkit_tpu_torch.codecs.aac import AacAdtsAdapter

    return AacAdtsAdapter()


def make_ac3_adapter():
    raise UnsupportedFormat("AC-3 decoder not yet available in the port")
