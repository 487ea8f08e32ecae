"""Adapter factories of the autodetect pipeline (counterpart of
``soundkit_tpu/pipeline/adapters.py``).

``decode_pipeline._init_decoder`` calls these lazily. The streaming
adapter of the Opus, Vorbis and Speex decoders and its factories live in
``codecs/containers.py``, as in the JAX package.
"""
from __future__ import annotations


def make_mp3_adapter(device="cuda"):
    from soundkit_tpu_torch.codecs.mp3 import Mp3Adapter

    return Mp3Adapter(device)


def make_aac_adts_adapter():
    from soundkit_tpu_torch.codecs.aac import AacAdtsAdapter

    return AacAdtsAdapter()


def make_ac3_adapter():
    from soundkit_tpu_torch.codecs.telephony import make_ac3_adapter as mk

    return mk()
