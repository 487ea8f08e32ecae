"""AAC-LC decoders on the host: ADTS streams, raw access units and
LOAS/LATM (counterpart of ``soundkit_tpu/codecs/aac.py``).

``AacDecoder`` frames ADTS (``aac_lc.AdtsStream``), parses each access
unit with the JAX package's own pure-Python ``AacLcDecoder`` and
synthesizes it with the numpy ``AacLcSynth`` (``ops/aac_dsp.py``), both
copied verbatim: the same code, so the same samples. The first access
unit gates the stream (``_prime``): AAC-LC, one or two channels, no SBR.
The batched AAC path on the card is ``models/aac_lc_batch.py``.

``AacRawDecoder`` decodes raw access units configured from an
AudioSpecificConfig (an M4A's ``esds``, a LATM StreamMuxConfig) with
the same two classes, as the JAX package's ``simple.AacLcStreamDecoder``
does, behind the same first-AU gate. ``AacLatmAdapter`` demuxes a LOAS
stream (``demux/latm.py``) into it, its decoder built once from the
first in-band config.

The JAX package hands to libavcodec what this gate refuses (HE-AAC /
SBR, more than two channels, a program config element, a first access
unit that does not parse) and continues a stream on a raw-AU libavcodec
decoder after a later access unit fails; its ``AacRawDecoder`` (M4A,
LATM) is libavcodec throughout. The port builds no FFmpeg: a refused
stream raises ``UnsupportedFormat`` before any output, a first access
unit that does not parse or a later failure raises ``DecodingFailed``,
once, after which the decoder gives nothing more. An M4A or LATM stream
that passes the gate decodes through the owned decoder where the JAX
package's libavcodec decodes it: a stated departure (the two lie
20-40 dB apart on the in-repo clips).
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


def _lc_config(asc: bytes):
    """(sampling frequency index, channels) of an AAC-LC
    AudioSpecificConfig the owned decoder serves; raises
    ``UnsupportedFormat`` for what it refuses (another object type, SBR or
    PS signalled explicitly, a PCE or more than two channels, 960-sample
    frames, an explicit sampling rate)."""
    if len(asc) < 2:
        raise DecodingFailed("AudioSpecificConfig too short")
    object_type = asc[0] >> 3
    sr_index = ((asc[0] & 0x7) << 1) | (asc[1] >> 7)
    channel_config = (asc[1] >> 3) & 0xF
    if object_type in (5, 29):
        raise UnsupportedFormat("HE-AAC (SBR / PS): the ported AAC decoder serves AAC-LC only "
                                "(no libavcodec)")
    if object_type != 2:
        raise UnsupportedFormat(f"AAC object type {object_type}: the ported AAC decoder serves "
                                "AAC-LC only (no libavcodec)")
    if sr_index >= len(SAMPLE_RATES):
        raise UnsupportedFormat(f"AudioSpecificConfig with sampling frequency index {sr_index}")
    if channel_config not in (1, 2):
        what = ("a program config element (channel configuration 0)"
                if channel_config == 0 else f"{channel_config} channel configuration")
        raise UnsupportedFormat(f"AudioSpecificConfig with {what}: the ported AAC decoder serves "
                                "mono and stereo AAC-LC only (no libavcodec)")
    if asc[1] & 0x4:
        raise UnsupportedFormat("AAC-LC with 960-sample frames (frameLengthFlag)")
    if len(asc) >= 5:  # a backward-compatible SBR signal after the GASpecificConfig
        ext = int.from_bytes(asc[2:5], "big")
        if ext >> 13 == 0x2B7 and (ext >> 8) & 0x1F == 5 and ext & 0x80:
            raise UnsupportedFormat("HE-AAC (SBR signalled in the AudioSpecificConfig): the "
                                    "ported AAC decoder serves AAC-LC only (no libavcodec)")
    return sr_index, channel_config


class AacRawDecoder:
    """Raw access-unit decoder configured from an AudioSpecificConfig
    (the M4A path: extradata from the MP4 esds box; the LATM path)."""

    def __init__(self, audio_specific_config: bytes) -> None:
        self._asc = bytes(audio_specific_config)
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
        """The ADTS path's first-AU gate on the config and the first
        access unit."""
        sr_index, chans = _lc_config(self._asc)
        try:
            dec = AacLcDecoder(sr_index)
            dec.decode_au(first_au)
        except Exception as e:
            raise DecodingFailed(f"first access unit does not parse as AAC-LC: {e}")
        if dec.sbr_seen:
            raise UnsupportedFormat("HE-AAC (SBR): the ported AAC decoder serves AAC-LC only "
                                    "(no libavcodec)")
        self._dec = AacLcDecoder(sr_index)
        self._synth = AacLcSynth(sr_index)
        self._rate = SAMPLE_RATES[sr_index]
        self._chans = chans

    def decode_access_unit_f32(self, au: bytes) -> np.ndarray:
        if self._failed:
            return np.zeros(0, dtype=np.float32)
        if self._dec is None:
            try:
                self._prime(au)
            except DecodeError:
                self._failed = True
                raise
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
        return pcm.T.reshape(-1).astype(np.float32)

    def flush_f32(self) -> np.ndarray:
        return np.zeros(0, dtype=np.float32)


class AacLatmAdapter:
    """StreamingDecoder for LOAS/LATM AAC elementary streams.

    Beyond reference parity (which only passes LATM packets through,
    soundkit-audio-demux/src/lib.rs:2249): demuxes the LOAS sync layer
    to raw access units (demux/latm.py) and decodes them with a
    raw-AU decoder configured from the in-band StreamMuxConfig's
    AudioSpecificConfig.
    """

    def __init__(self) -> None:
        from soundkit_tpu_torch.demux.latm import LoasDemuxer

        self._loas = LoasDemuxer()
        self._dec: Optional[AacRawDecoder] = None

    def _emit(self, pcm: np.ndarray) -> List[AudioData]:
        if pcm is None or pcm.size == 0 or not self._dec or not self._dec.sample_rate:
            return []
        pcm16 = f32_to_i16(pcm)
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
        out: List[AudioData] = []
        for au in self._loas.push(chunk):
            if self._dec is None:
                self._dec = AacRawDecoder(self._loas.config.asc.to_bytes())
            out.extend(self._emit(self._dec.decode_access_unit_f32(au)))
        return out

    def flush(self) -> List[AudioData]:
        if self._dec is None:
            return []
        return self._emit(self._dec.flush_f32())
