"""Adapter factories of the autodetect pipeline (counterpart of
``soundkit_tpu/pipeline/adapters.py``), and the streaming adapter of the
Opus and Vorbis decoders with its factories (counterpart of the part of
``soundkit_tpu/codecs/containers.py`` they live in there:
``_StreamI16Adapter``, ``make_ogg_opus_adapter``,
``make_opus_stream_adapter``, ``make_vorbis_adapter``).

``decode_pipeline._init_decoder`` calls these lazily. A codec the port
does not have yet raises ``UnsupportedFormat`` with a clear message
rather than failing detection.
"""
from __future__ import annotations

from typing import List

import numpy as np

from soundkit_tpu_torch.codecs.avdec import f32_to_i16
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.pipeline.output_options import UnsupportedFormat


def make_mp3_adapter(device="cuda"):
    from soundkit_tpu_torch.codecs.mp3 import Mp3Adapter

    return Mp3Adapter(device)


def make_aac_adts_adapter():
    from soundkit_tpu_torch.codecs.aac import AacAdtsAdapter

    return AacAdtsAdapter()


def make_ac3_adapter():
    raise UnsupportedFormat("AC-3 decoder not yet available in the port")


def _audio_i16(pcm16: np.ndarray, rate: int, channels: int) -> List[AudioData]:
    if len(pcm16) == 0:
        return []
    return [
        AudioData(
            bits_per_sample=16,
            channel_count=channels,
            sampling_rate=rate,
            data=np.asarray(pcm16, np.int16).astype("<i2").tobytes(),
            audio_format=EncodingFlag.PCM_SIGNED,
            endianness=Endianness.LITTLE,
        )
    ]


class _StreamI16Adapter:
    """Adapter over decoders exposing decode_i16/flush + rate/channels."""

    def __init__(self, dec):
        self._dec = dec

    def process(self, chunk: bytes) -> List[AudioData]:
        pcm = self._dec.decode_i16(chunk)
        rate = self._dec.sample_rate
        ch = self._dec.channels
        if not rate or not ch:
            return []
        return _audio_i16(pcm, rate, ch)

    def flush(self) -> List[AudioData]:
        pcm = f32_to_i16(self._dec.flush())
        rate = self._dec.sample_rate
        ch = self._dec.channels
        if not rate or not ch:
            return []
        return _audio_i16(pcm, rate, ch)


def make_ogg_opus_adapter():
    from soundkit_tpu_torch.codecs.opus import OggOpusDecoder

    return _StreamI16Adapter(OggOpusDecoder())


def make_opus_stream_adapter():
    from soundkit_tpu_torch.codecs.opus import OpusStreamDecoder

    return _StreamI16Adapter(OpusStreamDecoder())


def make_vorbis_adapter():
    from soundkit_tpu_torch.codecs.vorbis import VorbisDecoder

    return _StreamI16Adapter(VorbisDecoder())
