"""Streaming decode pipeline with automatic format detection
(counterpart of ``soundkit_tpu/pipeline/decode_pipeline.py``).

- Detecting state buffers input until >= 8192 bytes, tries detection,
  gives up past 64 KiB with ``FormatDetectionFailed``.
- Decoding state feeds each chunk to a ``StreamingDecoder`` adapter and
  applies ``DecodeOptions`` output conversion.
- EOF is an empty ``send(b"")``; flush drains decoder + resampler.
- ``DecodePipeline.spawn*`` start a worker thread with bounded
  input/output queues (128 each); ``send`` raises ``InputBufferFull``
  instead of blocking; errors flow as data in the output stream
  (DecodeOutput = AudioData | DecodeError).

The synchronous core (``StreamDecoder``) is reusable without threads.

The port's formats are WAV, raw PCM, G.711, G.722, G.726, FLAC, MP3,
AAC-ADTS, M4A (AAC or ALAC), LOAS/LATM AAC, Ogg Opus, soundkit's raw
Opus framing, Ogg Vorbis, WebM (Opus or Vorbis), GSM 06.10 (standard and
WAV49), AMR-NB, G.729, AC-3, Ogg Speex, ALAC (in MP4 or CAF) and AIFF /
AIFF-C. The
telephony codecs and MP3 launch their kernels (K3, K6, K7, K10) on
``device``, the card unless the caller names the CPU, and so does an
AIFF-C file's µ-law / A-law (K3 at EOF); the rest decode on the host.
M4A AAC, LATM AAC and WebM Opus decode through the owned AAC-LC and Opus
decoders where the JAX package opens libavcodec (a stated departure);
AMR-NB and G.729 (``spawn_amr_nb`` / ``spawn_g729``) decode through the
owned decoders where it opens libavcodec, with its framing and its
output. A stream the owned decoders refuse (HE-AAC, an AAC channel
configuration of 0 or beyond 7, a multistream head in the raw Opus
framing) raises ``UnsupportedFormat`` when it reaches them.

A decoder's exception becomes a ``DecodingFailed`` output, as in the
JAX package, but for a fault of the device (a failed kernel launch,
an error of the CUDA runtime): that reaches the caller of ``process``,
and of the threaded handle's ``recv*``.
"""
from __future__ import annotations

import queue
import threading
from typing import List, Optional, Union

import numpy as np

from soundkit_tpu_torch.codecs.g711 import G711Decoder, G711Law
from soundkit_tpu_torch.codecs.g722 import G722Decoder
from soundkit_tpu_torch.codecs.g726 import G726Decoder, G726Packing, G726Rate
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.core.raw_pcm import RawPcmFormat, RawPcmStreamProcessor
from soundkit_tpu_torch.core.wav import WavStreamProcessor, WavStreamError
from soundkit_tpu_torch.demux.detect import (
    AudioType,
    MAX_DETECTION_BYTES,
    MIN_DETECTION_BYTES,
    detect_audio,
)
from soundkit_tpu_torch.pipeline.output_options import (
    DecodeError,
    DecodeOptions,
    DecodingFailed,
    FormatDetectionFailed,
    InputBufferFull,
    NoAudioDecoded,
    UnsupportedFormat,
    apply_output_options,
)
from soundkit_tpu_torch.utils.device import is_device_fault, resolve_device

DecodeOutput = Union[AudioData, DecodeError]

DEFAULT_INPUT_BUFFER = 128
DEFAULT_OUTPUT_BUFFER = 128

def _audio_i16(samples: np.ndarray, rate: int, channels: int) -> AudioData:
    """create_audio_data_i16 equivalent (lib.rs:1160): i16 -> LE bytes."""
    return AudioData(
        bits_per_sample=16,
        channel_count=channels,
        sampling_rate=rate,
        data=np.asarray(samples, np.int16).astype("<i2").tobytes(),
        audio_format=EncodingFlag.PCM_SIGNED,
        endianness=Endianness.LITTLE,
    )


# ---------------------------------------------------------------------------
# StreamingDecoder adapters
# ---------------------------------------------------------------------------

class WavAdapter:
    def __init__(self) -> None:
        self._proc = WavStreamProcessor()

    def process(self, chunk: bytes) -> List[AudioData]:
        try:
            out = self._proc.add(chunk)
        except WavStreamError as e:
            raise DecodingFailed(str(e))
        frames = []
        while out is not None:
            frames.append(out)
            out = self._proc.add(b"")
        return frames

    def flush(self) -> List[AudioData]:
        return []


class RawPcmAdapter:
    def __init__(self, fmt: RawPcmFormat) -> None:
        self._proc = RawPcmStreamProcessor(fmt)

    def process(self, chunk: bytes) -> List[AudioData]:
        out = self._proc.add(chunk)
        return [out] if out is not None else []

    def flush(self) -> List[AudioData]:
        try:
            out = self._proc.flush()
        except ValueError as e:
            raise DecodingFailed(str(e))
        return [out] if out is not None else []


class G711Adapter:
    def __init__(self, law: G711Law, rate: int, channels: int, device="cuda") -> None:
        self._dec = G711Decoder(law, rate, channels, device)

    def process(self, chunk: bytes) -> List[AudioData]:
        if not chunk:
            return []
        pcm = self._dec.decode_i16(chunk)
        return [_audio_i16(pcm, self._dec.sample_rate, self._dec.channels)]

    def flush(self) -> List[AudioData]:
        return []


class G722Adapter:
    def __init__(self, device="cuda") -> None:
        self._dec = G722Decoder(device)

    def process(self, chunk: bytes) -> List[AudioData]:
        if not chunk:
            return []
        pcm = self._dec.decode_i16(chunk)
        return [_audio_i16(pcm, self._dec.sample_rate, self._dec.channels)]

    def flush(self) -> List[AudioData]:
        return []


class G726Adapter:
    def __init__(self, rate: G726Rate, packing: G726Packing, device="cuda") -> None:
        self._dec = G726Decoder(rate, packing, device)

    def process(self, chunk: bytes) -> List[AudioData]:
        if not chunk:
            return []
        pcm = self._dec.decode_i16(chunk)
        if len(pcm) == 0:
            return []
        return [_audio_i16(pcm, self._dec.sample_rate, self._dec.channels)]

    def flush(self) -> List[AudioData]:
        try:
            self._dec.flush()
        except ValueError as e:
            raise DecodingFailed(str(e))
        return []


class FlacAdapter:
    def __init__(self) -> None:
        from soundkit_tpu_torch.codecs.flac import FlacDecoder, FlacError

        self._err = FlacError
        self._dec = FlacDecoder()

    def process(self, chunk: bytes) -> List[AudioData]:
        try:
            out = self._dec.add(chunk)
        except self._err as e:
            raise DecodingFailed(str(e))
        return [out] if out is not None else []

    def flush(self) -> List[AudioData]:
        return self.process(b"")


def _init_decoder(audio_type: AudioType, device="cuda"):
    """The adapter of a detected format, its kernels on ``device``."""
    if audio_type == AudioType.WAV:
        return WavAdapter()
    if audio_type == AudioType.FLAC:
        return FlacAdapter()
    if audio_type == AudioType.MP3:
        from soundkit_tpu_torch.pipeline.adapters import make_mp3_adapter

        return make_mp3_adapter(device)
    if audio_type == AudioType.AAC:
        from soundkit_tpu_torch.pipeline.adapters import make_aac_adts_adapter

        return make_aac_adts_adapter()
    if audio_type == AudioType.AC3:
        from soundkit_tpu_torch.pipeline.adapters import make_ac3_adapter

        return make_ac3_adapter()
    if audio_type == AudioType.OGG_OPUS:
        from soundkit_tpu_torch.codecs.containers import make_ogg_opus_adapter

        return make_ogg_opus_adapter()
    if audio_type == AudioType.OGG_VORBIS:
        from soundkit_tpu_torch.codecs.containers import make_vorbis_adapter

        return make_vorbis_adapter()
    if audio_type == AudioType.OGG_SPEEX:
        from soundkit_tpu_torch.codecs.containers import make_speex_adapter

        return make_speex_adapter()
    if audio_type == AudioType.OPUS:
        from soundkit_tpu_torch.codecs.containers import make_opus_stream_adapter

        return make_opus_stream_adapter()
    if audio_type in (AudioType.M4A, AudioType.ALAC):
        from soundkit_tpu_torch.codecs.containers import AlacAdapter, M4aAdapter

        return AlacAdapter() if audio_type == AudioType.ALAC else M4aAdapter()
    if audio_type == AudioType.WEBM:
        from soundkit_tpu_torch.codecs.containers import WebmAdapter

        return WebmAdapter()
    if audio_type == AudioType.AIFF:
        from soundkit_tpu_torch.codecs.aiff import AiffAdapter

        return AiffAdapter(device)
    if audio_type == AudioType.UNKNOWN:
        raise FormatDetectionFailed()
    raise UnsupportedFormat(f"Unsupported format: {audio_type.value}")


# ---------------------------------------------------------------------------
# synchronous core
# ---------------------------------------------------------------------------

class StreamDecoder:
    """Detecting -> Decoding state machine, synchronous. A detected
    format's kernels run on ``device``."""

    def __init__(
        self,
        options: DecodeOptions = DecodeOptions(),
        initial_decoder=None,
        device="cuda",
    ) -> None:
        self.options = options
        self.device = resolve_device(device)
        self._decoder = initial_decoder
        self._detect_buf = bytearray()
        self._resampler_box: List[Optional[object]] = [None]
        self._finished = False
        self._emitted_audio = False
        self._fed_bytes = False  # any nonzero chunk ever arrived

    def process(self, chunk: bytes) -> List[DecodeOutput]:
        """Feed a chunk; empty chunk = EOF (triggers flush)."""
        if self._finished:
            return []
        if len(chunk) == 0:
            return self._flush()
        self._fed_bytes = True

        outputs: List[DecodeOutput] = []
        if self._decoder is None:
            self._detect_buf.extend(chunk)
            if len(self._detect_buf) < MIN_DETECTION_BYTES:
                return []
            buffered = bytes(self._detect_buf)
            try:
                audio_type = detect_audio(buffered)
                if audio_type == AudioType.UNKNOWN:
                    if len(buffered) >= MAX_DETECTION_BYTES:
                        self._finished = True
                        return [FormatDetectionFailed()]
                    return []
                self._decoder = _init_decoder(audio_type, self.device)
            except DecodeError as e:
                self._finished = True
                return [e]
            self._detect_buf.clear()
            chunk = buffered  # replay the whole buffered prefix

        try:
            frames = self._decoder.process(chunk)
            for audio in frames:
                outputs.extend(self._apply_options(audio))
        except DecodeError as e:
            outputs.append(e)
        except Exception as e:  # decoder bug: error-as-data, don't crash
            if is_device_fault(e):
                raise
            outputs.append(DecodingFailed(str(e)))
        return outputs

    def _apply_options(self, audio: AudioData) -> List[DecodeOutput]:
        self._emitted_audio = True
        try:
            return list(apply_output_options(audio, self.options, self._resampler_box))
        except DecodeError as e:
            return [e]

    def _flush(self) -> List[DecodeOutput]:
        self._finished = True
        outputs: List[DecodeOutput] = []
        if self._decoder is None:
            if not self._detect_buf:
                return outputs
            # EOF before MIN_DETECTION_BYTES: attempt detection on what
            # arrived (small complete files must still decode)
            buffered = bytes(self._detect_buf)
            self._detect_buf.clear()
            try:
                audio_type = detect_audio(buffered)
                if audio_type == AudioType.UNKNOWN:
                    return [FormatDetectionFailed()]
                self._decoder = _init_decoder(audio_type, self.device)
            except DecodeError as e:
                return [e]
            try:
                for audio in self._decoder.process(buffered):
                    outputs.extend(self._apply_options(audio))
            except DecodeError as e:
                outputs.append(e)
        try:
            for audio in self._decoder.flush():
                outputs.extend(self._apply_options(audio))
        except DecodeError as e:
            outputs.append(e)
        # a decoder that swallowed the entire stream without one PCM
        # frame (syncword-coincidence corrupt input) is an error, not a
        # clean empty EOF — unless an error was already reported
        if (
            not self._emitted_audio
            and self._fed_bytes
            and self._decoder is not None
            and not any(isinstance(o, DecodeError) for o in outputs)
        ):
            outputs.append(NoAudioDecoded())
        return outputs


# ---------------------------------------------------------------------------
# threaded pipeline API
# ---------------------------------------------------------------------------

_EOF = object()
_DONE = object()


class _Fault:
    """A device fault of the worker, handed to the receiving caller."""

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class DecodePipelineHandle:
    def __init__(self, core: StreamDecoder, input_buffer: int, output_buffer: int):
        self._in: "queue.Queue" = queue.Queue(maxsize=input_buffer)
        self._out: "queue.Queue" = queue.Queue(maxsize=output_buffer)
        self._core = core
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._in.get()
            eof = item is _EOF or len(item) == 0
            try:
                outputs = self._core.process(b"" if eof else item)
            except Exception as e:  # a device fault: the stream ends here
                self._out.put(_Fault(e))
                self._done.set()
                return
            for out in outputs:
                self._out.put(out)  # blocking push
            if eof:
                self._out.put(_DONE)
                self._done.set()
                return

    @staticmethod
    def _item(item) -> Optional[DecodeOutput]:
        if isinstance(item, _Fault):
            raise item.exc
        return None if item is _DONE else item

    def send(self, data: bytes) -> None:
        """Non-blocking; raises InputBufferFull when the ring is full."""
        try:
            self._in.put_nowait(bytes(data) if len(data) else _EOF)
        except queue.Full:
            raise InputBufferFull()

    def send_blocking(self, data: bytes, drained: Optional[list] = None) -> None:
        """Blocking send that stays deadlock-free by draining ready
        outputs into ``drained`` (or discarding them if None) while the
        input ring is full."""
        item = bytes(data) if len(data) else _EOF
        while True:
            try:
                self._in.put_nowait(item)
                return
            except queue.Full:
                try:
                    out = self._out.get(timeout=0.1)
                except queue.Empty:
                    continue
                out = self._item(out)
                if out is not None and drained is not None:
                    drained.append(out)

    def try_recv(self) -> Optional[DecodeOutput]:
        try:
            item = self._out.get_nowait()
        except queue.Empty:
            return None
        return self._item(item)

    def recv(self, timeout: Optional[float] = None) -> Optional[DecodeOutput]:
        """Blocking receive; returns None once the stream is finished."""
        try:
            item = self._out.get(timeout=timeout)
        except queue.Empty:
            return None
        return self._item(item)

    def recv_all(self, timeout: float = 30.0) -> List[DecodeOutput]:
        """Drain until the worker signals completion."""
        outputs = []
        while True:
            item = self._out.get(timeout=timeout)
            if item is _DONE:
                return outputs
            outputs.append(self._item(item))

    @property
    def finished(self) -> bool:
        return self._done.is_set()


class DecodePipeline:
    """spawn_* constructors; each takes ``device`` (the card by default)."""

    @staticmethod
    def _spawn(core: StreamDecoder, input_buffer=DEFAULT_INPUT_BUFFER,
               output_buffer=DEFAULT_OUTPUT_BUFFER) -> DecodePipelineHandle:
        return DecodePipelineHandle(core, input_buffer, output_buffer)

    @classmethod
    def spawn(cls, device="cuda") -> DecodePipelineHandle:
        return cls._spawn(StreamDecoder(device=device))

    @classmethod
    def spawn_with_options(cls, options: DecodeOptions, device="cuda") -> DecodePipelineHandle:
        return cls._spawn(StreamDecoder(options, device=device))

    @classmethod
    def spawn_with_buffers(cls, input_buffer: int, output_buffer: int,
                           device="cuda") -> DecodePipelineHandle:
        return cls._spawn(StreamDecoder(device=device), input_buffer, output_buffer)

    @classmethod
    def spawn_with_buffers_and_options(
        cls, input_buffer: int, output_buffer: int, options: DecodeOptions, device="cuda"
    ) -> DecodePipelineHandle:
        return cls._spawn(StreamDecoder(options, device=device), input_buffer, output_buffer)

    @classmethod
    def spawn_raw_pcm(
        cls, fmt: RawPcmFormat, options: DecodeOptions = DecodeOptions(), device="cuda"
    ) -> DecodePipelineHandle:
        return cls._spawn(StreamDecoder(options, RawPcmAdapter(fmt), device))

    @classmethod
    def spawn_g711(
        cls,
        law: G711Law,
        sample_rate: int = 8000,
        channels: int = 1,
        options: DecodeOptions = DecodeOptions(),
        device="cuda",
    ) -> DecodePipelineHandle:
        if sample_rate == 0 or channels == 0:
            raise DecodingFailed("invalid G.711 parameters")
        return cls._spawn(StreamDecoder(
            options, G711Adapter(law, sample_rate, channels, device), device))

    @classmethod
    def spawn_g722(cls, options: DecodeOptions = DecodeOptions(),
                   device="cuda") -> DecodePipelineHandle:
        return cls._spawn(StreamDecoder(options, G722Adapter(device), device))

    @classmethod
    def spawn_g726(
        cls, packing: G726Packing, options: DecodeOptions = DecodeOptions(), device="cuda"
    ) -> DecodePipelineHandle:
        return cls.spawn_g726_with_rate(G726Rate.RATE_32000, packing, options, device)

    @classmethod
    def spawn_g726_with_rate(
        cls,
        rate: G726Rate,
        packing: G726Packing,
        options: DecodeOptions = DecodeOptions(),
        device="cuda",
    ) -> DecodePipelineHandle:
        return cls._spawn(StreamDecoder(options, G726Adapter(rate, packing, device), device))

    @classmethod
    def spawn_flac(cls, options: DecodeOptions = DecodeOptions(),
                   device="cuda") -> DecodePipelineHandle:
        return cls._spawn(StreamDecoder(options, FlacAdapter(), device))

    @classmethod
    def spawn_mp3(cls, options: DecodeOptions = DecodeOptions(),
                  device="cuda") -> DecodePipelineHandle:
        from soundkit_tpu_torch.codecs.mp3 import Mp3Adapter

        return cls._spawn(StreamDecoder(options, Mp3Adapter(device), device))

    @classmethod
    def spawn_aac_adts(cls, options: DecodeOptions = DecodeOptions(),
                       device="cuda") -> DecodePipelineHandle:
        from soundkit_tpu_torch.codecs.aac import AacAdtsAdapter

        return cls._spawn(StreamDecoder(options, AacAdtsAdapter(), device))

    @classmethod
    def spawn_gsm(cls, variant=None, options: DecodeOptions = DecodeOptions(),
                  device="cuda") -> DecodePipelineHandle:
        from soundkit_tpu_torch.codecs.telephony import GsmVariant, make_gsm_adapter

        return cls._spawn(
            StreamDecoder(options, make_gsm_adapter(variant or GsmVariant.STANDARD), device))

    @classmethod
    def spawn_ac3(cls, options: DecodeOptions = DecodeOptions(),
                  device="cuda") -> DecodePipelineHandle:
        from soundkit_tpu_torch.codecs.telephony import make_ac3_adapter

        return cls._spawn(StreamDecoder(options, make_ac3_adapter(), device))

    @classmethod
    def spawn_vorbis(cls, options: DecodeOptions = DecodeOptions(),
                     device="cuda") -> DecodePipelineHandle:
        from soundkit_tpu_torch.codecs.containers import make_vorbis_adapter

        return cls._spawn(StreamDecoder(options, make_vorbis_adapter(), device))

    @classmethod
    def spawn_ogg_opus(cls, options: DecodeOptions = DecodeOptions(),
                       device="cuda") -> DecodePipelineHandle:
        from soundkit_tpu_torch.codecs.containers import make_ogg_opus_adapter

        return cls._spawn(StreamDecoder(options, make_ogg_opus_adapter(), device))

    @classmethod
    def spawn_opus(cls, options: DecodeOptions = DecodeOptions(),
                   device="cuda") -> DecodePipelineHandle:
        from soundkit_tpu_torch.codecs.containers import make_opus_stream_adapter

        return cls._spawn(StreamDecoder(options, make_opus_stream_adapter(), device))

    @classmethod
    def spawn_speex(cls, options: DecodeOptions = DecodeOptions(),
                    device="cuda") -> DecodePipelineHandle:
        from soundkit_tpu_torch.codecs.containers import make_speex_adapter

        return cls._spawn(StreamDecoder(options, make_speex_adapter(), device))

    @classmethod
    def spawn_alac(cls, options: DecodeOptions = DecodeOptions(),
                   device="cuda") -> DecodePipelineHandle:
        from soundkit_tpu_torch.codecs.containers import AlacAdapter

        return cls._spawn(StreamDecoder(options, AlacAdapter(), device))

    @classmethod
    def spawn_aiff(cls, options: DecodeOptions = DecodeOptions(),
                   device="cuda") -> DecodePipelineHandle:
        from soundkit_tpu_torch.codecs.aiff import AiffAdapter

        return cls._spawn(StreamDecoder(options, AiffAdapter(device), device))

    @classmethod
    def spawn_aac_latm(cls, options: DecodeOptions = DecodeOptions(),
                       device="cuda") -> DecodePipelineHandle:
        """LOAS/LATM AAC elementary stream (broadcast transport).

        Beyond reference parity: the reference only tags LATM packets
        (soundkit-audio-demux/src/lib.rs:2369); this path decodes them.
        """
        from soundkit_tpu_torch.codecs.aac import AacLatmAdapter

        return cls._spawn(StreamDecoder(options, AacLatmAdapter(), device))

    @classmethod
    def spawn_webm(cls, options: DecodeOptions = DecodeOptions(),
                   device="cuda") -> DecodePipelineHandle:
        from soundkit_tpu_torch.codecs.containers import WebmAdapter

        return cls._spawn(StreamDecoder(options, WebmAdapter(), device))

    # formats the JAX package decodes through libavcodec: the owned
    # decoders take its place

    @classmethod
    def spawn_amr_nb(cls, options: DecodeOptions = DecodeOptions(), device="cuda"):
        from soundkit_tpu_torch.codecs.telephony import make_amr_adapter

        return cls._spawn(StreamDecoder(options, make_amr_adapter(), device))

    @classmethod
    def spawn_g729(cls, options: DecodeOptions = DecodeOptions(), device="cuda"):
        from soundkit_tpu_torch.codecs.telephony import make_g729_adapter

        return cls._spawn(StreamDecoder(options, make_g729_adapter(), device))
