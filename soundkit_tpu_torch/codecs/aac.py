"""AAC-LC decoders on the host: ADTS streams, raw access units and
LOAS/LATM (counterpart of ``soundkit_tpu/codecs/aac.py``).

``AacDecoder`` frames ADTS (``aac_lc.AdtsStream``), parses each access
unit with the JAX package's own pure-Python ``AacLcDecoder`` and
synthesizes it with the numpy ``AacLcSynth`` (``ops/aac_dsp.py``), both
copied verbatim: the same code, so the same samples. The first access
unit gates the stream (``_prime``): AAC-LC at channel configuration 1-7,
no SBR. Every access unit must carry its configuration's elements
(``codecs/aac_layout.py``), and the channels come out in libavcodec's
order (``aac_layout.LIBAVCODEC_ORDER``: L R C LFE and the rest), where
the synthesis gives them in bitstream order. The batched AAC path on the
card is ``models/aac_lc_batch.py`` (mono and stereo).

``AacRawDecoder`` decodes raw access units configured from an
AudioSpecificConfig (an M4A's ``esds``, a LATM StreamMuxConfig) with
the same two classes, as the JAX package's ``simple.AacLcStreamDecoder``
does, behind the same first-AU gate. ``AacLatmAdapter`` demuxes a LOAS
stream (``demux/latm.py``) into it, its decoder built once from the
first in-band config.

The JAX package hands to libavcodec what its owned path refuses (HE-AAC
/ SBR, more than two channels, a program config element, a first access
unit that does not parse) and continues a stream on a raw-AU libavcodec
decoder after a later access unit fails; its ``AacRawDecoder`` (M4A,
LATM) is libavcodec throughout. The port builds no FFmpeg. It decodes
configurations 3-7 with the owned decoder in libavcodec's order (a
stated departure: the two agree on the channels, the length and every
frame without perceptual noise substitution). A refused stream raises
``UnsupportedFormat`` before any output: HE-AAC, another object type, a
program config element (configuration 0), or a first access unit whose
elements are not its configuration's (the last also refused by the JAX
package's libavcodec). A first access unit that does not parse (a
coupling channel element among them) or a later failure, a unit with
another element list included, raises ``DecodingFailed``, once, after
which the decoder gives nothing more. An M4A or LATM stream that passes
the gate decodes through the owned decoder where the JAX package's
libavcodec decodes it: a stated departure.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from soundkit_tpu_torch.codecs import aac_layout
from soundkit_tpu_torch.codecs.aac_lc import SAMPLE_RATES, AacLcDecoder, AdtsStream
from soundkit_tpu_torch.codecs.avdec import f32_to_i16
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.ops.aac_dsp import AacLcSynth
from soundkit_tpu_torch.pipeline.output_options import (DecodeError, DecodingFailed,
                                                       UnsupportedFormat)


def _refuse_config(what: str, config: int) -> UnsupportedFormat:
    return UnsupportedFormat(f"{what} with {aac_layout.config_name(config)}: the ported AAC "
                             "decoder serves AAC-LC at channel configurations 1-7 only "
                             "(no libavcodec)")


def _open_lc(sr_index: int, config: int, first_au: bytes, what: str, unit: str):
    """(parser, synthesis, rate, channels) of an AAC-LC stream of channel
    configuration ``config`` whose first access unit is ``first_au``;
    raises ``UnsupportedFormat`` for a configuration beyond 1-7, SBR or
    a first unit of other elements than its configuration's, and
    ``DecodingFailed`` for a first unit that does not parse."""
    if config not in aac_layout.CONFIG_ELEMENTS:
        raise _refuse_config(what, config)
    try:
        dec = AacLcDecoder(sr_index)
        frame = dec.decode_au(first_au)
    except Exception as e:
        raise DecodingFailed(f"{unit} does not parse as AAC-LC: {e}")
    if dec.sbr_seen:
        raise UnsupportedFormat("HE-AAC (SBR): the ported AAC decoder serves AAC-LC only "
                                "(no libavcodec)")
    try:
        aac_layout.check_elements(frame, config)
    except ValueError as e:
        raise UnsupportedFormat(f"{what}: {e}")
    return (AacLcDecoder(sr_index), AacLcSynth(sr_index), SAMPLE_RATES[sr_index],
            aac_layout.CHANNELS[config])


def _decode_unit(dec: AacLcDecoder, synth: AacLcSynth, config: int, au: bytes) -> np.ndarray:
    """One access unit as interleaved float32 in libavcodec's channel
    order; ``DecodingFailed`` for a unit that does not parse, carries
    SBR or other elements than configuration ``config``'s."""
    try:
        frame = dec.decode_au(au)
        if dec.sbr_seen:
            raise ValueError("HE-AAC SBR extension")
        aac_layout.check_elements(frame, config)
        pcm = synth.process_frame(frame)
    except Exception as e:
        raise DecodingFailed(f"AAC access unit failed mid-stream: {e}")
    return aac_layout.to_output_order(pcm, config).T.reshape(-1).astype(np.float32)


class AacDecoder:
    """Streaming ADTS decoder (AAC-LC)."""

    def __init__(self) -> None:
        self._adts = AdtsStream()
        self._dec: Optional[AacLcDecoder] = None
        self._synth: Optional[AacLcSynth] = None
        self._failed = False
        self._rate: Optional[int] = None
        self._chans: Optional[int] = None
        self._config = 0

    @property
    def sample_rate(self) -> Optional[int]:
        return self._rate

    @property
    def channels(self) -> Optional[int]:
        return self._chans

    def _prime(self, first_au: bytes) -> None:
        """First-AU gate: LC only, channel configuration 1-7 with its
        elements, no SBR extension; raises ``UnsupportedFormat`` for what
        it refuses and ``DecodingFailed`` for an access unit that does
        not parse."""
        st = self._adts
        self._dec, self._synth, self._rate, self._chans = _open_lc(
            st.sr_index, st.channel_config, first_au, "ADTS stream", "first ADTS access unit")
        self._config = st.channel_config

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
        try:
            if self._dec is None:
                self._prime(aus[0])
            outs = [_decode_unit(self._dec, self._synth, self._config, au) for au in aus]
        except DecodeError:
            self._failed = True
            raise
        return np.concatenate(outs)

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
    """(sampling frequency index, channel configuration) of an AAC-LC
    AudioSpecificConfig the owned decoder serves; raises
    ``UnsupportedFormat`` for what it refuses (another object type, SBR or
    PS signalled explicitly, a PCE or a configuration beyond 7, 960-sample
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
    if channel_config not in aac_layout.CONFIG_ELEMENTS:
        raise _refuse_config("AudioSpecificConfig", channel_config)
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
        self._config = 0

    @property
    def sample_rate(self) -> Optional[int]:
        return self._rate

    @property
    def channels(self) -> Optional[int]:
        return self._chans

    def _prime(self, first_au: bytes) -> None:
        """The ADTS path's first-AU gate on the config and the first
        access unit."""
        sr_index, self._config = _lc_config(self._asc)
        self._dec, self._synth, self._rate, self._chans = _open_lc(
            sr_index, self._config, first_au, "AudioSpecificConfig", "first access unit")

    def decode_access_unit_f32(self, au: bytes) -> np.ndarray:
        if self._failed:
            return np.zeros(0, dtype=np.float32)
        try:
            if self._dec is None:
                self._prime(au)
            return _decode_unit(self._dec, self._synth, self._config, au)
        except DecodeError:
            self._failed = True
            raise

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
