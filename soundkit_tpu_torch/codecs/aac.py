"""AAC-LC ADTS streaming decoder on the host (counterpart of
``soundkit_tpu/codecs/aac.py``).

``AacDecoder`` frames ADTS (``aac_lc.AdtsStream``), parses each access
unit with the JAX package's own pure-Python ``AacLcDecoder`` and
synthesizes it with the numpy ``AacLcSynth`` (``ops/aac_dsp.py``), both
copied verbatim: the same code, so the same samples. The first access
unit gates the stream (``_prime``): AAC-LC, one or two channels, no SBR.
The batched AAC path on the card is ``models/aac_lc_batch.py``.

The JAX package hands to libavcodec what this gate refuses (HE-AAC /
SBR, more than two channels, a program config element, a first access
unit that does not parse) and continues a stream on a raw-AU libavcodec
decoder after a later access unit fails. The port builds no FFmpeg: a
refused stream raises ``UnsupportedFormat`` before any output, a first
access unit that does not parse or a later failure raises
``DecodingFailed``, once, after which the decoder gives nothing more. ``AacRawDecoder`` and ``AacLatmAdapter`` (raw AUs
and LOAS/LATM through libavcodec) are not ported.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from soundkit_tpu_torch.codecs.aac_lc import SAMPLE_RATES, AacLcDecoder, AdtsStream
from soundkit_tpu_torch.codecs.avdec import f32_to_i16
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.ops.aac_dsp import AacLcSynth
from soundkit_tpu_torch.pipeline.output_options import (DecodeError, DecodingFailed,
                                                       UnsupportedFormat)


class AacDecoder:
    """Streaming ADTS decoder (AAC-LC)."""

    def __init__(self) -> None:
        self._adts = AdtsStream()
        self._dec: Optional[AacLcDecoder] = None
        self._synth: Optional[AacLcSynth] = None
        self._failed = False
        self._rate: Optional[int] = None
        self._chans: Optional[int] = None

    @property
    def sample_rate(self) -> Optional[int]:
        return self._rate

    @property
    def channels(self) -> Optional[int]:
        return self._chans

    def _prime(self, first_au: bytes) -> None:
        """First-AU gate: LC only, <= 2 channels, no SBR extension;
        raises ``UnsupportedFormat`` for what it refuses and
        ``DecodingFailed`` for an access unit that does not parse."""
        st = self._adts
        if st.channel_config not in (1, 2):
            what = ("a program config element (channel configuration 0)"
                    if st.channel_config == 0 else f"{st.channel_config} channel configuration")
            raise UnsupportedFormat(f"ADTS stream with {what}: the ported AAC decoder serves "
                                    "mono and stereo AAC-LC only (no libavcodec)")
        try:
            dec = AacLcDecoder(st.sr_index)
            dec.decode_au(first_au)
        except Exception as e:
            raise DecodingFailed(f"first ADTS access unit does not parse as AAC-LC: {e}")
        if dec.sbr_seen:
            raise UnsupportedFormat("HE-AAC (SBR): the ported AAC decoder serves AAC-LC only "
                                    "(no libavcodec)")
        self._dec = AacLcDecoder(st.sr_index)
        self._synth = AacLcSynth(st.sr_index)
        self._rate = SAMPLE_RATES[st.sr_index]
        self._chans = st.channel_config

    def decode_f32(self, data: bytes) -> np.ndarray:
        if self._failed:
            return np.zeros(0, dtype=np.float32)
        try:
            aus = self._adts.push(data)
        except Exception as e:
            self._failed = True
            raise DecodingFailed(f"ADTS framing failed: {e}")
        if not aus:
            return np.zeros(0, dtype=np.float32)
        if self._dec is None:
            try:
                self._prime(aus[0])
            except DecodeError:
                self._failed = True
                raise
        outs = []
        for au in aus:
            try:
                frame = self._dec.decode_au(au)
                if self._dec.sbr_seen:
                    raise ValueError("HE-AAC SBR extension")
                pcm = self._synth.process_frame(frame)
                if pcm.shape[0] != self._chans:
                    raise ValueError("channel layout change")
            except Exception as e:
                self._failed = True
                raise DecodingFailed(f"AAC access unit failed mid-stream: {e}")
            outs.append(pcm.T.reshape(-1).astype(np.float32))
        return np.concatenate(outs).astype(np.float32)

    def decode_i16(self, data: bytes) -> np.ndarray:
        return f32_to_i16(self.decode_f32(data))

    def flush_f32(self) -> np.ndarray:
        return np.zeros(0, dtype=np.float32)


class AacAdtsAdapter:
    """StreamingDecoder for the pipeline (ADTS autodetect path)."""

    def __init__(self) -> None:
        self._dec = AacDecoder()

    def _emit(self, pcm16: np.ndarray) -> List[AudioData]:
        if len(pcm16) == 0 or not self._dec.sample_rate:
            return []
        return [
            AudioData(
                bits_per_sample=16,
                channel_count=self._dec.channels,
                sampling_rate=self._dec.sample_rate,
                data=pcm16.astype("<i2").tobytes(),
                audio_format=EncodingFlag.PCM_SIGNED,
                endianness=Endianness.LITTLE,
            )
        ]

    def process(self, chunk: bytes) -> List[AudioData]:
        return self._emit(self._dec.decode_i16(chunk))

    def flush(self) -> List[AudioData]:
        return self._emit(f32_to_i16(self._dec.flush_f32()))
